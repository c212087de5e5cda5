"""Pair-index matching (port of ``matching/runner.match_pair_indices``).

Genuine and impostor pairs are index arrays into one (S, K) gallery of
templates on a device, matched in chunks. There is one route on every
device, the one the JAX package takes on its accelerator: the cascade
screen is ``cuda_match.screen_promote_batch`` (``screen_pairs_batch_kernel
| anchor_promote``) and the full pass is ``cuda_match.match_pairs_batch``;
only the hypothesis-scoring wrapper looks at the device (kernel D on CUDA,
its plain twin on the CPU). The JAX package's CPU route
(``use_pallas=False``) screens with the full matcher instead
(``ransac.screen_promote_batch``); the port does not reproduce that rule.
Results are per pair, so the last chunk is not padded to a fixed shape
(the JAX package pads only to avoid recompiles).

``main()`` (YAML config, CSV report, ROC plot) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.minutiae import MinutiaeSet
from ..preprocessing.enhance import exact_float32
from .cuda_match import match_pairs_batch, screen_promote_batch
from .dataset import MinutiaeDataset
from .ransac import MatchParams


def _gather(ds: MinutiaeDataset, idx: np.ndarray) -> MinutiaeSet:
    sel = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(
        ds.stacked.valid.device)
    return MinutiaeSet(*(x[sel] for x in ds.stacked))


def screen_pair_indices(ds: MinutiaeDataset, pairs: np.ndarray,
                        params: MatchParams, chunk: int = 512,
                        screen_iters: int = 32) -> np.ndarray:
    """(P,) promote bits of the cascade screen for (P, 2) sample-index
    pairs: ``screen_iters`` hypotheses (a prefix of the full pass's) with
    min_inliers relaxed by 2 (at least 3), OR-ed with the recall anchors."""
    screen_p = params._replace(ransac_iter=screen_iters,
                               full_iters=params.ransac_iter,
                               min_inliers=max(3, params.min_inliers - 2))
    return torch.cat([
        screen_promote_batch(_gather(ds, pairs[i:i + chunk, 0]),
                             _gather(ds, pairs[i:i + chunk, 1]), screen_p)
        for i in range(0, pairs.shape[0], chunk)]).cpu().numpy()


def match_pair_indices(ds: MinutiaeDataset, pairs: np.ndarray,
                       params: MatchParams, chunk: int = 512,
                       cascade: bool = False,
                       screen_iters: int = 32) -> dict:
    """Match (P, 2) sample-index pairs in chunks of ``chunk`` pairs on the
    gallery's device. Returns numpy arrays final_score / n_inliers / theta /
    t per pair.

    cascade=True runs a two-phase screen (``screen_pair_indices``) for
    every pair, then the full ``params.ransac_iter`` pass only on the
    promoted pairs. Pairs the screen drops score 0."""
    exact_float32()
    n = pairs.shape[0]
    if n == 0:
        return {"final_score": np.zeros(0), "n_inliers": np.zeros(0, np.int32),
                "theta": np.zeros(0), "t": np.zeros((0, 2))}

    if cascade and params.ransac_iter > screen_iters:
        promising = screen_pair_indices(ds, pairs, params, chunk, screen_iters)
        out = {
            "final_score": np.zeros(n), "n_inliers": np.zeros(n, np.int32),
            "theta": np.zeros(n), "t": np.zeros((n, 2)),
        }
        idx = np.nonzero(promising)[0]
        if idx.size:
            full = match_pair_indices(ds, pairs[idx], params, chunk=chunk)
            for key in out:
                out[key][idx] = full[key]
        return out

    # every chunk is queued on the device before any result is copied back
    res = [match_pairs_batch(_gather(ds, pairs[i:i + chunk, 0]),
                             _gather(ds, pairs[i:i + chunk, 1]), params)
           for i in range(0, n, chunk)]
    return {key: torch.cat([getattr(r, key) for r in res]).cpu().numpy()
            for key in ("final_score", "n_inliers", "theta", "t")}
