"""Minutiae dataset loading for evaluation (port of ``matching/dataset.py``).

Walks a minutiae directory for ``*_minutiae.json``, groups by user id
(filename prefix before the first underscore), caps samples per user, and
builds the (N, 7) matrices plus a padded (S, K) MinutiaeSet on a device.
File order, grouping, seeding and pair order are the JAX package's, so both
packages build identical pair lists.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..features.minutiae import MinutiaeSet, from_matrix
from ..utils.device import resolve_device
from ..utils.io import load_minutiae_matrix, pad_minutiae


class MinutiaeDataset(NamedTuple):
    users: list[str]            # unique user ids, sorted
    user_index: np.ndarray      # (S,) int: user of each sample
    sample_index: np.ndarray    # (S,) int: per-user sample position
    matrices: list[np.ndarray]  # raw (N, 7) matrices
    stacked: MinutiaeSet        # (S, K) padded tensors on the device

    def as_dict(self) -> dict[str, list[np.ndarray]]:
        """The {user_id: [(N, 7) arrays]} view."""
        out: dict[str, list[np.ndarray]] = {u: [] for u in self.users}
        for ui, m in zip(self.user_index, self.matrices):
            out[self.users[ui]].append(m)
        return out


def load_dataset(minutiae_base: str | Path, max_per_user: int | None = None,
                 k: int = 64, device=None) -> MinutiaeDataset:
    """Load every ``*_minutiae.json`` under ``minutiae_base`` onto ``device``
    (default: the card; pass ``"cpu"`` to run there). Raises if the card is
    asked for, by default or by name, and CUDA is not available."""
    device = resolve_device(device, "load_dataset")
    base = Path(minutiae_base)
    files = sorted(base.rglob("*_minutiae.json"))

    by_user: dict[str, list[Path]] = {}
    for f in files:
        user = f.name.split("_")[0]
        by_user.setdefault(user, []).append(f)

    users = sorted(by_user)
    user_index, sample_index, matrices = [], [], []
    mats_padded, valids = [], []
    for ui, user in enumerate(users):
        paths = sorted(by_user[user])
        if max_per_user is not None:
            paths = paths[:max_per_user]
        for si, p in enumerate(paths):
            mat = load_minutiae_matrix(p)
            matrices.append(mat)
            user_index.append(ui)
            sample_index.append(si)
            padded, valid = pad_minutiae(mat, k)
            mats_padded.append(padded)
            valids.append(valid)

    if matrices:
        mat_t = torch.from_numpy(np.stack(mats_padded))
        valid_t = torch.from_numpy(np.stack(valids))
    else:
        mat_t = torch.zeros((0, k, 7), dtype=torch.float32)
        valid_t = torch.zeros((0, k), dtype=torch.bool)
    return MinutiaeDataset(
        users=users,
        user_index=np.asarray(user_index, dtype=np.int32),
        sample_index=np.asarray(sample_index, dtype=np.int32),
        matrices=matrices,
        stacked=from_matrix(mat_t.to(device), valid_t.to(device)),
    )


def genuine_pairs(ds: MinutiaeDataset, max_pairs_per_user: int | None = None
                  ) -> np.ndarray:
    """All within-user sample pairs (i, j), i < j."""
    pairs = []
    for ui in range(len(ds.users)):
        idx = np.nonzero(ds.user_index == ui)[0]
        user_pairs = [(int(a), int(b))
                      for n, a in enumerate(idx) for b in idx[n + 1:]]
        if max_pairs_per_user is not None:
            user_pairs = user_pairs[:max_pairs_per_user]
        pairs.extend(user_pairs)
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def impostor_pairs(ds: MinutiaeDataset, peers_per_user: int = 100,
                   seed: int = 42) -> np.ndarray:
    """Sampled cross-user pairs: all cross-sample pairs for each (user,
    sampled peer), each unordered user pair once, seeded."""
    rng = np.random.default_rng(seed)
    n_users = len(ds.users)
    samples_of = [np.nonzero(ds.user_index == ui)[0] for ui in range(n_users)]
    pairs = []
    for ui in range(n_users):
        others = [v for v in range(n_users) if v != ui]
        if not others:
            continue
        chosen = rng.choice(len(others), size=min(peers_per_user, len(others)),
                            replace=False)
        for c in chosen:
            vi = others[int(c)]
            if vi < ui:
                continue  # each unordered user pair scored once
            for a in samples_of[ui]:
                for b in samples_of[vi]:
                    pairs.append((int(a), int(b)))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
