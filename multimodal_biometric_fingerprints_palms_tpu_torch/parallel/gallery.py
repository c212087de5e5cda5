"""1:N identification and all-pairs scoring of a gallery (port of
``parallel/gallery.py``).

The gallery is an (N, K) MinutiaeSet. A mesh (``parallel/mesh.py``) is one
device, or W ranks of a process group with a device each; every rank calls
each function with the same arguments, as one JAX controller calls it, and
gets the whole result. The work is split as the JAX package's ``shard_map``
splits it:

- ``shard_gallery``: rank r holds rows [r N/W, (r+1) N/W) on its device
  (a ``GalleryShard``); every function takes the whole gallery or such a
  shard, as the JAX functions take a global array however it is placed;
- ``all_pairs_scores``: each rank scores its rows against every row, the
  column side the ``all_gather`` of every rank's rows;
- ``shard_pairs_scores``, ``shard_pairs_screen``: the pair list padded to
  W x per_dev by repeating its last pair and split evenly, the gallery
  replicated; ``shard_blocks_screen`` splits its block pairs the same way;
- ``identify``, ``identify_batch``: each rank scores its N / W rows;
- ``ShardedGallery``: the same identification as a service whose gallery
  stays on the ranks of a ``parallel.launch.RankGroup`` between calls.

Each rank's results are gathered in rank order (``all_gather``) and the
padding dropped. The mesh, not where the caller built the tensors, decides
where the work runs: inputs are moved to the rank's device first. Every
function walks pairs of template indices in chunks through the matcher's
batch entry points: the full pass ``cuda_match.match_pairs_batch`` and the
cascade screen ``cuda_match.screen_promote_batch``, so kernel D scores
them on the card and its plain twin on the CPU. Results are per pair: how
pairs are split into calls or over ranks changes none of them, and on one
device nothing is padded.

Two TPU workarounds of the JAX package are not carried over. A template
gather is ``index_select``, not a one-hot matmul. The blocked screen scores
a whole (block x block) tile a matcher call, where the JAX package split it
into 512-pair pieces to keep an XLA compile in bounds: the port compiles
nothing, and at 512 pairs a call the matcher is bound by its launches.
``use_pallas`` is dropped (one route on every device, as in
``matching/runner.py``); the JAX package's CPU route screens with the full
matcher, the port everywhere with the accelerator rule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..features.minutiae import MinutiaeSet
from ..matching.cuda_match import match_pairs_batch, screen_promote_batch
from ..matching.ransac import MatchParams
from ..utils.profiling import count, span, traced
from .collectives import broadcast_rows, gather_rows
from .mesh import Mesh, gallery_sharding, replicated

# Pairs a matcher call in ``identify_batch``: the JAX package matches all
# P x chunk pairs of a column chunk at once (65,536 at its defaults), but
# the sampling's (pairs, H, K) float32 tensors would take 5 GB each at
# H=300; at 4,096 pairs the full pass keeps the card busy (PERF.md).
_PAIR_BATCH = 4096


class GalleryShard(MinutiaeSet):
    """A rank's rows of a gallery sharded over a mesh (``shard_gallery``);
    on a mesh of one device, the whole gallery."""
    __slots__ = ()


def _device(ms: MinutiaeSet) -> torch.device:
    return ms.valid.device


def _on(ms: MinutiaeSet, dev: torch.device) -> MinutiaeSet:
    return MinutiaeSet(*(x.to(dev) for x in ms))


def _whole(gallery: MinutiaeSet, mesh: Mesh) -> MinutiaeSet:
    """The whole ``gallery`` (a shard is gathered) on this rank's device."""
    if isinstance(gallery, GalleryShard):
        return MinutiaeSet(*(gather_rows(x, mesh)
                             for x in _on(gallery, mesh.device)))
    return _on(gallery, replicated(mesh).device)


def _share(items: np.ndarray, mesh: Mesh, multiple: int):
    """This rank's share of ``items`` (rows): on W > 1 ranks the rows are
    padded by repeating the last to W x per_dev, per_dev a multiple of
    ``multiple``, and split evenly; on one device all of them, unpadded."""
    if mesh.size == 1:
        return items
    per_dev = -(-len(items) // (mesh.size * multiple)) * multiple
    pad = mesh.size * per_dev - len(items)
    if pad:
        items = np.concatenate([items, np.repeat(items[-1:], pad, axis=0)])
    return items[mesh.rank * per_dev:(mesh.rank + 1) * per_dev]


def shard_gallery(gallery: MinutiaeSet, mesh: Mesh,
                  axis_name: str = "gallery") -> GalleryShard:
    """This rank's rows [r N/W, (r+1) N/W) of the (N, K) MinutiaeSet, on
    its device (on one device: all of them). N must be divisible by the
    mesh size (pad with invalid templates if needed)."""
    if isinstance(gallery, GalleryShard):
        return GalleryShard(*_on(gallery, mesh.device))
    n = gallery.valid.shape[0]
    if n % mesh.size:
        raise ValueError(f"gallery size {n} not divisible by mesh "
                         f"{mesh.size}")
    n_local, r = n // mesh.size, mesh.rank
    dev = gallery_sharding(mesh, axis_name).device
    return GalleryShard(*(x[r * n_local:(r + 1) * n_local].to(dev)
                          for x in gallery))


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
    every rank's device: each rank scores its rows against the
    ``all_gather`` of every rank's rows, one row's ``col_chunk`` columns a
    matcher call.

    DEMO/REFERENCE PATH, as in the JAX package: production all-pairs
    scoring is ``shard_pairs_scores`` / ``all_pairs_unique``. Diagonal
    (self-match) included; callers mask it."""
    local = shard_gallery(gallery, mesh, axis_name)
    n = local.valid.shape[0] * mesh.size
    if n % col_chunk and n >= col_chunk:
        raise ValueError(
            f"gallery size {n} not divisible by col_chunk {col_chunk}")
    full = _whole(local, mesh)
    dev = _device(local)
    ia = torch.arange(local.valid.shape[0], device=dev).repeat_interleave(n)
    ib = torch.arange(n, device=dev).repeat(local.valid.shape[0])
    s, _ = _match_indexed(local, ia, full, ib, params, min(col_chunk, n))
    return gather_rows(s.reshape(-1, n), mesh)


def _pairs_local(gallery, pairs, mesh, chunk):
    """(the whole gallery on this rank's device, this rank's pairs as two
    index tensors, the pair count)."""
    gallery = _whole(gallery, mesh)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    ia, ib = _pair_columns(gallery, _share(pairs, mesh, chunk))
    return gallery, ia, ib, len(pairs)


def shard_pairs_scores(gallery: MinutiaeSet, pairs, mesh: Mesh,
                       params: MatchParams = MatchParams(),
                       axis_name: str = "gallery",
                       chunk: int = 2048):
    """Score an explicit (P, 2) template-index pair list, split over the
    mesh's ranks, ``chunk`` pairs a matcher call. Returns (scores (P,),
    n_inliers (P,)) as numpy arrays. Counts ``gallery.full_pairs``: the
    pairs this rank scores."""
    gallery, ia, ib, total = _pairs_local(gallery, pairs, mesh, chunk)
    if total == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    count("gallery.full_pairs", ia.shape[0])
    s, n = _match_indexed(gallery, ia, gallery, ib, params, chunk)
    return (gather_rows(s, mesh)[:total].cpu().numpy(),
            gather_rows(n, mesh)[:total].cpu().numpy())


def shard_pairs_screen(gallery: MinutiaeSet, pairs, mesh: Mesh,
                       params: MatchParams = MatchParams(),
                       axis_name: str = "gallery",
                       chunk: int = 2048,
                       anchors: bool = True) -> np.ndarray:
    """Cascade screen over an explicit (P, 2) pair list under ``params``
    (the caller passes the screen's), split over the mesh's ranks: (P,)
    bool promote bits of ``screen_promote_batch``, ``chunk`` pairs a
    call."""
    gallery, ia, ib, total = _pairs_local(gallery, pairs, mesh, chunk)
    if total == 0:
        return np.zeros(0, dtype=bool)
    out = torch.cat([
        screen_promote_batch(take_templates(gallery, ia[s:s + chunk]),
                             take_templates(gallery, ib[s:s + chunk]),
                             params, anchors)
        for s in range(0, ia.shape[0], chunk)])
    return gather_rows(out, mesh)[:total].cpu().numpy()


def unique_pairs(n: int) -> np.ndarray:
    """(N*(N-1)/2, 2) upper-triangle index pairs (i < j)."""
    iu = np.triu_indices(n, k=1)
    return np.stack(iu, axis=1).astype(np.int32)


@traced("gallery.screen")
def shard_blocks_screen(gallery: MinutiaeSet, mesh: Mesh,
                        params: MatchParams,
                        axis_name: str = "gallery",
                        block: int = 64,
                        anchors: bool = True):
    """Cascade screen over ALL unique pairs in (block x block) template
    tiles of the gallery padded to a multiple of ``block``: each tile's
    full cross product is one ``screen_promote_batch`` call, the block
    pairs split over the mesh's ranks.

    Returns (block_pairs (NBP, 2), mask (NBP, block*block)) as numpy:
    block pairs (bi <= bj) in ``np.triu_indices`` order, and mask[r, k]
    promotes global pair (bi*block + k//block, bj*block + k%block): the A
    side repeat-major, the B side tile-minor.

    Span ``gallery.screen``, ending after the mask's copy to the host, and
    one ``gallery.screen_tile`` a tile; counts ``gallery.screen_pairs``:
    the block x block pairs of each tile this rank scores."""
    gpad = pad_gallery(_whole(gallery, mesh), block)
    nb = gpad.valid.shape[0] // block
    bi, bj = np.triu_indices(nb, k=0)
    bp = np.stack([bi, bj], axis=1).astype(np.int32)
    k = torch.arange(block * block, device=_device(gpad))
    il, jl = k // block, k % block
    rows = []
    for r, c in _share(bp, mesh, 1):
        with span("gallery.screen_tile"):
            count("gallery.screen_pairs", block * block)
            rows.append(screen_promote_batch(
                take_templates(gpad, int(r) * block + il),
                take_templates(gpad, int(c) * block + jl),
                params, anchors))
    return bp, gather_rows(torch.stack(rows), mesh)[:len(bp)].cpu().numpy()


@traced("gallery.all_pairs")
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
    Every rank runs this orchestration on the same gathered results, so
    every rank makes the same calls.

    Returns (P,) float64 final scores aligned with ``unique_pairs(N)``.

    Spans, under ``gallery.all_pairs``: ``gallery.screen``,
    ``gallery.promote_index`` (the promoted pairs' indices, on the host)
    and ``gallery.full_pass``; counts ``gallery.promoted_pairs``."""
    gallery = _whole(gallery, mesh)
    n = gallery.valid.shape[0]
    pairs = unique_pairs(n)
    if not (cascade and params.ransac_iter > screen_iters):
        with span("gallery.full_pass"):
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
    with span("gallery.promote_index"):
        # promoted (block pair, local k) entries back to unique-pair slots:
        # k = i_local * block + j_local
        il, jl = np.divmod(np.arange(block * block), block)
        gi = bp[:, :1] * block + il[None, :]
        gj = bp[:, 1:] * block + jl[None, :]
        keep = mask & (gi < gj) & (gj < n)
        ii, jj = gi[keep].astype(np.int64), gj[keep].astype(np.int64)
        pos = ii * (2 * n - ii - 1) // 2 + (jj - ii - 1)
        count("gallery.promoted_pairs", ii.size)
    out = np.zeros(pairs.shape[0], np.float64)
    if ii.size:
        with span("gallery.full_pass"):
            s1, _ = shard_pairs_scores(gallery, np.stack([ii, jj], axis=1),
                                       mesh, params, axis_name, chunk)
        out[pos] = s1
    return out


def identify(probe: MinutiaeSet, gallery: MinutiaeSet, mesh: Mesh,
             params: MatchParams = MatchParams(),
             axis_name: str = "gallery",
             chunk: int = 1024) -> torch.Tensor:
    """1:N identification: (N,) scores of one (K,) probe against the
    gallery, on every rank's device, ``chunk`` gallery templates a call:
    ``identify_batch`` of one probe."""
    return identify_batch(MinutiaeSet(*(x[None] for x in probe)), gallery,
                          mesh, params, axis_name, chunk)[0]


@traced("gallery.identify")
def identify_batch(probes: MinutiaeSet, gallery: MinutiaeSet, mesh: Mesh,
                   params: MatchParams = MatchParams(),
                   axis_name: str = "gallery",
                   chunk: int = 1024) -> torch.Tensor:
    """Batched 1:N identification: (P, K) probes against the (N, K)
    gallery -> (P, N) scores on every rank's device. Each rank walks its
    N / W rows in column chunks of ``chunk`` templates; a chunk's P x chunk
    pairs, probe-major as in the JAX package, go to the matcher as many
    probes' rows at a time as fit ``_PAIR_BATCH`` pairs (at least one).
    The ranks' (P, N / W) blocks are gathered in rank order."""
    gallery = shard_gallery(gallery, mesh, axis_name)
    n_local = gallery.valid.shape[0]
    chunk = min(chunk, n_local)
    if n_local % chunk:
        raise ValueError(f"gallery rows per device {n_local} not divisible "
                         f"by chunk {chunk}")
    probes = _whole(probes, mesh)
    dev = _device(gallery)
    p_num = probes.valid.shape[0]
    ia = torch.arange(p_num, device=dev).repeat_interleave(chunk)
    jb = torch.arange(chunk, device=dev).repeat(p_num)
    step = max(1, _PAIR_BATCH // chunk) * chunk
    cols = [_match_indexed(probes, ia, gallery, jb + c0, params,
                           step)[0].reshape(p_num, chunk)
            for c0 in range(0, n_local, chunk)]
    local = torch.cat(cols, dim=1)
    if mesh.size == 1:
        return local
    return _gather_columns(local, mesh)


def _gather_columns(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (P, N / W) block of scores, side by side in rank
    order: (P, N) on every rank."""
    p_num, n_local = local.shape
    blocks = gather_rows(local, mesh).reshape(mesh.size, p_num, n_local)
    return blocks.permute(1, 0, 2).reshape(p_num, mesh.size * n_local)


# --- a gallery that stays on the ranks of a RankGroup --------------------------

_SHARD = "gallery.shard"


def _header(ms: MinutiaeSet) -> list:
    """(shape, dtype) of each field: what a follower allocates to receive
    ``ms`` over the group."""
    return [(tuple(x.shape), x.dtype) for x in ms]


def _broadcast_set(ms: MinutiaeSet | None, header: list, mesh: Mesh
                   ) -> MinutiaeSet:
    """Rank 0's MinutiaeSet on every rank's device, field by field over
    the group (``ms`` is None on the other ranks)."""
    dev = mesh.device
    got = [x.to(dev).contiguous() if ms is not None else
           torch.empty(shape, dtype=dtype, device=dev)
           for x, (shape, dtype) in zip(ms or [None] * len(header), header)]
    return MinutiaeSet(*(broadcast_rows(x, mesh) for x in got))


def _load_rank(ctx, gallery, header) -> None:
    """Keep this rank's rows of rank 0's gallery (a ``RankGroup`` call)."""
    mesh = ctx.mesh
    whole = _broadcast_set(gallery, header, mesh)
    shard = shard_gallery(whole, mesh)
    ctx.state[_SHARD] = (GalleryShard(*(x.clone() for x in shard)),
                         Mesh((mesh.device,), mesh.axis_name))


def _identify_rank(ctx, probes, header, params, chunk):
    """This rank's share of ``ShardedGallery.identify_batch`` (a
    ``RankGroup`` call): rank 0's probes over the group, this rank's
    shard scored alone, the blocks gathered in rank order."""
    mesh = ctx.mesh
    shard, own = ctx.state[_SHARD]
    with span("gallery.broadcast"):
        probes = _broadcast_set(probes, header, mesh)
    with span("gallery.local"):
        local = identify_batch(probes, shard, own, params, chunk=chunk)
    if mesh.size == 1:
        return local
    with span("gallery.gather"):
        count("gallery.gathered_bytes",
              local.numel() * local.element_size() * mesh.size)
        return _gather_columns(local, mesh)


class ShardedGallery:
    """1:N identification against a gallery held on the ranks of a
    ``parallel.launch.RankGroup`` between calls: rank r keeps rows
    [r N/W, (r+1) N/W) on its device.

    ``load(gallery)`` sends rank 0's (N, K) gallery to every rank once
    (a broadcast a field; each rank keeps its rows). ``identify_batch``
    sends rank 0's (P, K) probes the same way (nothing is pickled), each
    rank runs ``identify_batch`` on its shard alone, and the (P, N / W)
    blocks are gathered in rank order: (P, N) scores on rank 0's device,
    equal to ``identify_batch`` on one device. Spans ``gallery.broadcast``,
    ``gallery.local`` (the shard's scoring) and ``gallery.gather``;
    counts ``gallery.gathered_bytes`` (P x N x 4 a call). On a group of one
    rank nothing is exchanged: a call is ``identify_batch``."""

    def __init__(self, group, params: MatchParams = MatchParams(),
                 chunk: int = 1024):
        self.group, self.params, self.chunk = group, params, chunk
        self.rows = 0

    def load(self, gallery: MinutiaeSet) -> None:
        """Place the gallery's rows on the ranks; N must be a multiple of
        the group's size times ``chunk`` (``pad_gallery``)."""
        n, w = gallery.valid.shape[0], self.group.n
        per = n // w
        if n % w or per == 0 or per % min(self.chunk, per):
            raise ValueError(f"gallery of {n} rows: not {w} shards of whole "
                             f"chunks of {self.chunk} (pad_gallery)")
        self.group.call(_load_rank, _header(gallery), data=gallery)
        self.rows = n

    def identify_batch(self, probes: MinutiaeSet) -> torch.Tensor:
        """(P, N) scores of the (P, K) probes against the loaded gallery,
        on rank 0's device."""
        if not self.rows:
            raise ValueError("ShardedGallery.identify_batch before load")
        return self.group.call(_identify_rank, _header(probes), self.params,
                               self.chunk, data=probes)
