"""Entry points of the port (the JAX package's ``__graft_entry__``).

- ``entry()``: the flagship SSL forward (EfficientNetV2-S, 756 -> 512 ->
  256, predictor on) on 8 images of 224 x 224, on the card unless given
  ``device="cpu"``. The weights are seeded from 0 with flax's initialisers
  (``models.seed_weights``), not flax's own draws; the function is the
  model, so a caller can load other weights into it
  (``models.load_jax_variables``).
- ``dryrun_multichip(n)``: n ranks (``parallel/launch.py``), one a card
  (or gloo ranks on the CPU with ``device="cpu"``), run one data-parallel
  SSL training step and the production gallery paths over a PolyU-scale
  gallery, with the JAX dry run's sizes, assertions and printed line.

``python -m multimodal_biometric_fingerprints_palms_tpu_torch.entry`` runs
the dry run over every visible card, at most 8.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .models import SSLModel, seed_weights
from .utils.device import resolve_device

# The JAX dry run's sizes: PolyU's 1,480 templates as 370 users x 4
# jittered impressions, the 16,384-pair sample with 256 planted genuine
# pairs, at most 4,096 promoted pairs in the full pass, 4 probes.
POLYU = dict(users=370, per_user=4, sample=16384, planted=256,
             full_cap=4096, probes=4)


def entry(device=None):
    """Returns (fn, example_args): ``fn`` the SSL model in eval mode on
    ``device``, ``example_args`` one (8, 224, 224) float32 batch in [0, 1]
    (``np.random.default_rng(0)``, as the JAX entry point draws it)."""
    device = resolve_device(device, "entry")
    model = SSLModel(backbone_name="effnetv2_s", embedding_dim=756,
                     proj_hidden_dim=512, proj_output_dim=256)
    model = seed_weights(model, 0).to(device).eval()
    x = torch.from_numpy(
        np.random.default_rng(0).random((8, 224, 224), np.float32)).to(device)
    return model, (x,)


def _ssl_step(mesh) -> float:
    """One data-parallel SSL step on ``effnetv2_tiny`` (64 -> 64 -> 32),
    64 x 64 views, a global batch of 2 a rank; returns the loss."""
    from .parallel.collectives import broadcast_state, rank_rows
    from .train.optim import ClipAdamW
    from .train.ssl_train import create_ssl_train_step, init_ssl_state
    from .utils import threefry

    model = SSLModel(backbone_name="effnetv2_tiny", embedding_dim=64,
                     proj_hidden_dim=64, proj_output_dim=32).to(mesh.device)
    tx = ClipAdamW(1.0, 1e-4, 1e-5)
    state = init_ssl_state(model, threefry.key(0), (64, 64), tx)
    broadcast_state(model, mesh)
    rng = np.random.default_rng(0)
    x_i, x_j = (torch.from_numpy(rank_rows(
        rng.random((2 * mesh.size, 64, 64), np.float32), mesh)
    ).to(mesh.device) for _ in range(2))
    step = create_ssl_train_step(model, tx, temperature=0.5)
    _, loss = step(state, x_i, x_j, threefry.key(1), mesh)
    return float(loss)


def _polyu_gallery(n_pad: int, users: int, per_user: int, k: int = 64):
    """The JAX dry run's gallery: ``users`` constellations of 12 minutiae
    spread over the frame, ``per_user`` 1-px jitters of each, random
    orientations and types per user; rows past users x per_user are
    invalid. Returns (numpy fields, labels with -1 on padding)."""
    n = users * per_user
    g = np.random.default_rng(1)
    base_xy = g.random((users, 12, 2), dtype=np.float32) * [200.0, 280.0] + 20
    jitter = g.normal(0, 1.0, (users, per_user, 12, 2)).astype(np.float32)
    xy = np.zeros((n_pad, k, 2), np.float32)
    xy[:n, :12] = (base_xy[:, None] + jitter).reshape(n, 12, 2)
    q = np.zeros((n_pad, k), np.float32)
    q[:n, :12] = 0.8
    valid = np.zeros((n_pad, k), bool)
    valid[:n, :12] = True
    base_ori = (g.random((users, 12), dtype=np.float32) - 0.5) * np.pi
    base_type = (g.random((users, 12)) > 0.5).astype(np.int32)
    ori = np.zeros((n_pad, k), np.float32)
    ori[:n, :12] = np.repeat(base_ori, per_user, axis=0)
    mtype = np.zeros((n_pad, k), np.int32)
    mtype[:n, :12] = np.repeat(base_type, per_user, axis=0)
    labels = np.full((n_pad,), -1, np.int64)
    labels[:n] = np.repeat(np.arange(users), per_user)
    fields = dict(xy=xy, minutia_type=mtype, orientation=ori, quality=q,
                  coherence=q, angular_stability=q, valid=valid)
    return fields, labels


def dryrun_rank(sizes: dict) -> str:
    """One rank's part of the dry run (run it through
    ``parallel.launch.run_ranks``): the SSL step, then the gallery paths at
    ``sizes`` (``POLYU``'s keys). Returns the dry run's line."""
    from .features.minutiae import MinutiaeSet, minutiae_from_numpy
    from .matching.ransac import MatchParams
    from .parallel.gallery import (identify_batch, shard_gallery,
                                   shard_pairs_scores, shard_pairs_screen,
                                   unique_pairs)
    from .parallel.mesh import create_mesh

    mesh = create_mesh(axis_name="data")
    w = mesh.size
    loss = _ssl_step(mesh)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")

    users, per_user = sizes["users"], sizes["per_user"]
    n = users * per_user
    n_pad = -(-n // w) * w
    fields, labels = _polyu_gallery(n_pad, users, per_user)
    gallery = minutiae_from_numpy(fields)
    gmesh = create_mesh(axis_name="gallery")
    params = MatchParams(ransac_iter=8, min_inliers=5)
    full_sweep = os.environ.get("MBFP_DRYRUN_FULL") == "1"

    pairs = unique_pairs(n)
    if not full_sweep and len(pairs) > sizes["sample"]:
        # planted genuine pairs (user u owns templates 4u .. 4u+3), so the
        # sample always carries genuine structure
        gsel = np.random.default_rng(2).choice(users, size=sizes["planted"],
                                               replace=False)
        planted = np.stack([per_user * gsel, per_user * gsel + 1],
                           axis=1).astype(pairs.dtype)
        sel = np.random.default_rng(0).choice(
            len(pairs), size=sizes["sample"] - len(planted), replace=False)
        pairs = np.concatenate([planted, pairs[np.sort(sel)]], axis=0)
    screen_p = params._replace(ransac_iter=4, full_iters=params.ransac_iter,
                               min_inliers=max(3, params.min_inliers - 2))
    t0 = time.time()
    promising = shard_pairs_screen(gallery, pairs, gmesh, screen_p,
                                   chunk=2048)
    t_screen = time.time() - t0
    t0 = time.time()
    idx = np.nonzero(promising)[0]
    t_host = time.time() - t0
    genuine_mask = labels[pairs[:, 0]] == labels[pairs[:, 1]]
    n_genuine = int(genuine_mask.sum())
    n_gen_promoted = int((promising & genuine_mask).sum())
    if n_gen_promoted == 0:
        raise AssertionError(f"screen promoted 0 of {n_genuine} genuine "
                             "pairs: the cascade's genuine path never ran")
    n_gen_scored = 0
    t0 = time.time()
    if idx.size:
        sub, sub_genuine = pairs[idx], genuine_mask[idx]
        if not full_sweep:              # bound the sampled dry run's full pass
            sub = sub[:sizes["full_cap"]]
            sub_genuine = sub_genuine[:sizes["full_cap"]]
        s_full, _ = shard_pairs_scores(gallery, sub, gmesh, params,
                                       chunk=2048)
        n_gen_scored = int((s_full[sub_genuine] > 0).sum())
        if n_gen_scored == 0:
            raise AssertionError(
                "full pass scored 0 on every promoted genuine pair")
    t_full = time.time() - t0

    sharded = shard_gallery(gallery, gmesh)
    probes = MinutiaeSet(*(x[:sizes["probes"]] for x in gallery))
    t0 = time.time()
    idb = identify_batch(probes, sharded, gmesh, params,
                         chunk=n_pad // w).cpu()
    t_idb = time.time() - t0
    if tuple(idb.shape) != (sizes["probes"], n_pad):
        raise AssertionError(f"identify_batch shape {tuple(idb.shape)}")
    return (f"dryrun_multichip({w}): ssl loss={loss:.4f}; "
            f"PolyU-scale all-pairs N={n} ({len(pairs)} unique pairs, "
            f"{n_genuine} genuine): "
            f"screen {t_screen:.2f}s, host-orchestration {t_host*1000:.0f}ms, "
            f"promoted {idx.size} ({100.0*idx.size/len(pairs):.2f}%; "
            f"genuine {n_gen_promoted}/{n_genuine}), "
            f"full-pass {t_full:.2f}s ({n_gen_scored} genuine pairs scored>0); "
            f"batched identify P={sizes['probes']}xN={n_pad} {t_idb:.2f}s ok")


def dryrun_multichip(n_devices: int, timeout: float = 900.0, device=None
                     ) -> str:
    """One data-parallel SSL training step and the PolyU-scale gallery
    paths over ``n_devices`` ranks, one a card (``device="cpu"``: gloo
    ranks on the CPU). Prints and returns rank 0's line."""
    from .parallel.launch import run_ranks
    kind = resolve_device(device, "dryrun_multichip").type
    lines = run_ranks(dryrun_rank, n_devices, POLYU, device=kind,
                      timeout=timeout)
    print(lines[0])
    return lines[0]


if __name__ == "__main__":
    resolve_device(None, "dryrun_multichip")
    dryrun_multichip(min(8, torch.cuda.device_count()))
