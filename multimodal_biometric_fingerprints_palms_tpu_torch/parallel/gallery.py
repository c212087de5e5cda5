"""1:N identification and all-pairs scoring of a gallery (port of
``parallel/gallery.py``).

The gallery is an (N, K) MinutiaeSet. Every function that takes a mesh
first places the gallery (and the probes) on the mesh's device (one
device, see ``parallel/mesh.py``), as the JAX package's ``shard_map``
places them through its ``in_specs``: the mesh, not where the caller built
the tensors, decides where the work runs. Every function walks pairs of template indices in
chunks through the matcher's batch entry points: the full pass
``cuda_match.match_pairs_batch`` and the cascade screen
``cuda_match.screen_promote_batch``, so kernel D scores them on the card
and its plain twin on the CPU. Results are per pair: how pairs are split
into calls changes none of them, and the last chunk is not padded.

Two TPU workarounds of the JAX package are not carried over. A template
gather is ``index_select``, not a one-hot matmul. The blocked screen scores
a whole (block x block) tile a matcher call, where the JAX package split it
into 512-pair pieces to keep an XLA compile in bounds: the port compiles
nothing, and at 512 pairs a call the matcher is bound by its launches.
``use_pallas`` is dropped (one route on every device, as in
``matching/runner.py``); the JAX package's CPU route screens with the full
matcher, the port everywhere with the accelerator rule.

``n_local = n // n_dev`` and the divisibility checks are kept as the JAX
package has them, so a multi-GPU mesh changes the device count and nothing
else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.minutiae import MinutiaeSet
from ..matching.cuda_match import match_pairs_batch, screen_promote_batch
from ..matching.ransac import MatchParams
from .mesh import Mesh, gallery_sharding

# Pairs a matcher call in ``identify_batch``: the JAX package matches all
# P x chunk pairs of a column chunk at once (65,536 at its defaults), but
# the sampling's (pairs, H, K) float32 tensors would take 5 GB each at
# H=300; at 4,096 pairs the full pass keeps the card busy (PERF.md).
_PAIR_BATCH = 4096


def _device(ms: MinutiaeSet) -> torch.device:
    return ms.valid.device


def shard_gallery(gallery: MinutiaeSet, mesh: Mesh,
                  axis_name: str = "gallery") -> MinutiaeSet:
    """The (N, K) MinutiaeSet on the mesh's device. N must be divisible by
    the mesh size (pad with invalid templates if needed)."""
    dev = gallery_sharding(mesh, axis_name).device
    return MinutiaeSet(*(x.to(dev) for x in gallery))


def pad_gallery(gallery: MinutiaeSet, multiple: int) -> MinutiaeSet:
    """Pad the template axis to a multiple with all-zero templates, which
    are invalid and score 0 against everything."""
    pad = (-gallery.valid.shape[0]) % multiple
    if pad == 0:
        return gallery
    return MinutiaeSet(*(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                         for x in gallery))


def take_templates(gallery: MinutiaeSet, idx) -> MinutiaeSet:
    """Template rows by index (a tensor or array-like of ints)."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=_device(gallery))
    return MinutiaeSet(*(x.index_select(0, idx) for x in gallery))


def _match_indexed(a: MinutiaeSet, ia: torch.Tensor, b: MinutiaeSet,
                   ib: torch.Tensor, params: MatchParams, chunk: int):
    """(final_score, n_inliers) of the pairs (a[ia[i]], b[ib[i]]), full
    pass, ``chunk`` pairs a matcher call; every call is queued on the
    device before any result is read."""
    res = [match_pairs_batch(take_templates(a, ia[s:s + chunk]),
                             take_templates(b, ib[s:s + chunk]), params)
           for s in range(0, ia.shape[0], chunk)]
    if not res:
        return (torch.zeros(0, device=_device(a)),
                torch.zeros(0, dtype=torch.int32, device=_device(a)))
    return (torch.cat([r.final_score for r in res]),
            torch.cat([r.n_inliers for r in res]))


def _pair_columns(gallery: MinutiaeSet, pairs):
    """A (P, 2) pair list as two index tensors on the gallery's device."""
    pairs = torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2),
                            device=_device(gallery))
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()


def all_pairs_scores(gallery: MinutiaeSet, mesh: Mesh,
                     params: MatchParams = MatchParams(),
                     axis_name: str = "gallery",
                     col_chunk: int = 64) -> torch.Tensor:
    """(N, N) final-score matrix of every template against every other, on
    the mesh's device, one row's ``col_chunk`` columns a matcher call.

    DEMO/REFERENCE PATH, as in the JAX package: production all-pairs
    scoring is ``shard_pairs_scores`` / ``all_pairs_unique``. Diagonal
    (self-match) included; callers mask it."""
    n = gallery.valid.shape[0]
    n_dev = mesh.size
    if n % n_dev:
        raise ValueError(f"gallery size {n} not divisible by mesh {n_dev}")
    if n % col_chunk and n >= col_chunk:
        raise ValueError(
            f"gallery size {n} not divisible by col_chunk {col_chunk}")
    gallery = shard_gallery(gallery, mesh, axis_name)
    rows = torch.arange(n, device=_device(gallery))
    s, _ = _match_indexed(gallery, rows.repeat_interleave(n), gallery,
                          rows.repeat(n), params, min(col_chunk, n))
    return s.reshape(n, n)


def shard_pairs_scores(gallery: MinutiaeSet, pairs, mesh: Mesh,
                       params: MatchParams = MatchParams(),
                       axis_name: str = "gallery",
                       chunk: int = 2048):
    """Score an explicit (P, 2) template-index pair list, ``chunk`` pairs a
    matcher call. Returns (scores (P,), n_inliers (P,)) as numpy arrays."""
    gallery = shard_gallery(gallery, mesh, axis_name)
    ia, ib = _pair_columns(gallery, pairs)
    s, n = _match_indexed(gallery, ia, gallery, ib, params, chunk)
    return s.cpu().numpy(), n.cpu().numpy()


def shard_pairs_screen(gallery: MinutiaeSet, pairs, mesh: Mesh,
                       params: MatchParams = MatchParams(),
                       axis_name: str = "gallery",
                       chunk: int = 2048,
                       anchors: bool = True) -> np.ndarray:
    """Cascade screen over an explicit (P, 2) pair list under ``params``
    (the caller passes the screen's): (P,) bool promote bits of
    ``screen_promote_batch``, ``chunk`` pairs a call."""
    gallery = shard_gallery(gallery, mesh, axis_name)
    ia, ib = _pair_columns(gallery, pairs)
    out = [screen_promote_batch(take_templates(gallery, ia[s:s + chunk]),
                                take_templates(gallery, ib[s:s + chunk]),
                                params, anchors)
           for s in range(0, ia.shape[0], chunk)]
    return (torch.cat(out).cpu().numpy() if out
            else np.zeros(0, dtype=bool))


def unique_pairs(n: int) -> np.ndarray:
    """(N*(N-1)/2, 2) upper-triangle index pairs (i < j)."""
    iu = np.triu_indices(n, k=1)
    return np.stack(iu, axis=1).astype(np.int32)


def shard_blocks_screen(gallery: MinutiaeSet, mesh: Mesh,
                        params: MatchParams,
                        axis_name: str = "gallery",
                        block: int = 64,
                        anchors: bool = True):
    """Cascade screen over ALL unique pairs in (block x block) template
    tiles of the gallery padded to a multiple of ``block``: each tile's
    full cross product is one ``screen_promote_batch`` call.

    Returns (block_pairs (NBP, 2), mask (NBP, block*block)) as numpy:
    block pairs (bi <= bj) in ``np.triu_indices`` order, and mask[r, k]
    promotes global pair (bi*block + k//block, bj*block + k%block): the A
    side repeat-major, the B side tile-minor."""
    gpad = pad_gallery(shard_gallery(gallery, mesh, axis_name), block)
    nb = gpad.valid.shape[0] // block
    bi, bj = np.triu_indices(nb, k=0)
    bp = np.stack([bi, bj], axis=1).astype(np.int32)
    k = torch.arange(block * block, device=_device(gpad))
    il, jl = k // block, k % block
    mask = torch.stack([
        screen_promote_batch(take_templates(gpad, int(r) * block + il),
                             take_templates(gpad, int(c) * block + jl),
                             params, anchors)
        for r, c in bp])
    return bp, mask.cpu().numpy()


def all_pairs_unique(gallery: MinutiaeSet, mesh: Mesh,
                     params: MatchParams = MatchParams(),
                     axis_name: str = "gallery",
                     chunk: int = 2048,
                     cascade: bool = True,
                     screen_iters: int = 32,
                     anchors: bool = True) -> np.ndarray:
    """All unique template pairs of a gallery, scored with the two-phase
    cascade: the blocked ``screen_iters``-hypothesis screen over every pair
    (min_inliers relaxed by 2, at least 3; its hypotheses a prefix of the
    full pass's), then the full ``params.ransac_iter`` pass, ``chunk`` pairs
    a call, on the promoted pairs only. Pairs the screen drops score 0.

    Returns (P,) float64 final scores aligned with ``unique_pairs(N)``."""
    gallery = shard_gallery(gallery, mesh, axis_name)
    n = gallery.valid.shape[0]
    pairs = unique_pairs(n)
    if not (cascade and params.ransac_iter > screen_iters):
        s, _ = shard_pairs_scores(gallery, pairs, mesh, params, axis_name,
                                  chunk)
        return s.astype(np.float64)
    screen_p = params._replace(
        ransac_iter=screen_iters,
        full_iters=params.ransac_iter,
        min_inliers=max(3, params.min_inliers - 2))
    block = 64
    bp, mask = shard_blocks_screen(gallery, mesh, screen_p, axis_name,
                                   block, anchors)
    # promoted (block pair, local k) entries back to unique-pair slots:
    # k = i_local * block + j_local
    il, jl = np.divmod(np.arange(block * block), block)
    gi = bp[:, :1] * block + il[None, :]
    gj = bp[:, 1:] * block + jl[None, :]
    keep = mask & (gi < gj) & (gj < n)
    ii, jj = gi[keep].astype(np.int64), gj[keep].astype(np.int64)
    out = np.zeros(pairs.shape[0], np.float64)
    if ii.size:
        pos = ii * (2 * n - ii - 1) // 2 + (jj - ii - 1)
        s1, _ = shard_pairs_scores(gallery, np.stack([ii, jj], axis=1), mesh,
                                   params, axis_name, chunk)
        out[pos] = s1
    return out


def identify(probe: MinutiaeSet, gallery: MinutiaeSet, mesh: Mesh,
             params: MatchParams = MatchParams(),
             axis_name: str = "gallery",
             chunk: int = 1024) -> torch.Tensor:
    """1:N identification: (N,) scores of one (K,) probe against the
    gallery, on the mesh's device, ``chunk`` gallery templates a call:
    ``identify_batch`` of one probe."""
    return identify_batch(MinutiaeSet(*(x[None] for x in probe)), gallery,
                          mesh, params, axis_name, chunk)[0]


def identify_batch(probes: MinutiaeSet, gallery: MinutiaeSet, mesh: Mesh,
                   params: MatchParams = MatchParams(),
                   axis_name: str = "gallery",
                   chunk: int = 1024) -> torch.Tensor:
    """Batched 1:N identification: (P, K) probes against the (N, K)
    gallery -> (P, N) scores on the mesh's device. The gallery is walked
    in column chunks of ``chunk`` templates; a chunk's P x chunk pairs,
    probe-major as in the JAX package, go to the matcher as many probes'
    rows at a time as fit ``_PAIR_BATCH`` pairs (at least one)."""
    n = gallery.valid.shape[0]
    n_local = n // mesh.size
    chunk = min(chunk, n_local)
    if n_local % chunk:
        raise ValueError(f"gallery rows per device {n_local} not divisible "
                         f"by chunk {chunk}")
    gallery = shard_gallery(gallery, mesh, axis_name)
    probes = shard_gallery(probes, mesh, axis_name)
    dev = _device(gallery)
    p_num = probes.valid.shape[0]
    ia = torch.arange(p_num, device=dev).repeat_interleave(chunk)
    jb = torch.arange(chunk, device=dev).repeat(p_num)
    step = max(1, _PAIR_BATCH // chunk) * chunk
    cols = [_match_indexed(probes, ia, gallery, jb + c0, params,
                           step)[0].reshape(p_num, chunk)
            for c0 in range(0, n_local, chunk)]
    return torch.cat(cols, dim=1)
