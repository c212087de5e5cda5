"""RANSAC hypothesis scoring: kernel D (``csrc/match.cu``) and its plain twin;
the per-pair statistics and hypothesis sampling: kernel I (``csrc/sample.cu``),
whose plain twin is ``ransac._pair_stats`` followed by
``ransac.sample_hypotheses``; the finish: kernel H (``csrc/finish.cu``), whose
plain twin is ``ransac._finish_match``; the cascade screen's recall anchors:
kernel J (``csrc/anchor.cu``), whose plain twin is ``ransac._anchor_promote``;
and the matcher's batch entry points built on them (port of
``matching/pallas_match.py`` and of the batch functions of
``matching/ransac.py``).

Kernel D replaces the TPU kernels ``hypothesis_scores_pallas_grouped``
(``_grouped_kernel``) and ``hypothesis_scores_pallas`` (``_match_kernel``),
which compute the same outputs. For every pair and sampled hypothesis
(theta, t): transform A, find each A minutia's nearest neighbour in B by the
unique-min encoding min(round(d2*256), 2^18-1)*K + j, gate on distance,
orientation and type, and score
min(exp(0.75*log(max(sum exp(-d2/sd2 - dth^2/so2)*wa*wb / (possible+1e-6),
1e-30))), 1), zeroed below ``min_inliers`` or without a candidate.

Validity is baked into the coordinates as the grouped TPU kernel does:
invalid A slots sit at (+1e6, +1e6) and invalid B slots at (-1e6, -1e6),
so no invalid pairing passes the distance gate and no mask is needed. The
plain twin stages that as feature planes (``_features``); the kernel reads
the matcher's own tensors and displaces on load, so a call is one launch.

``sample_pairs``, ``hypothesis_scores``, ``finish_match`` and
``anchor_pairs`` dispatch on the device: CPU tensors run the plain twin, CUDA
tensors launch the kernel; anything else raises. Every matcher entry point
samples through ``sample_pairs`` and scores through ``hypothesis_scores``,
the full pass finishes through ``finish_match`` and the screen's anchors
run through ``anchor_pairs``, so there is one scoring route on every
device: the JAX package's XLA route
(``ransac.match_pairs_batch``, ``raw ** 0.75``) and its Pallas route
compute the same results within the tests' tolerances, and the port
reproduces the Pallas kernels' formula.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..features.minutiae import MinutiaeSet
from ..kernels import build as _build
from ..utils.profiling import count, span, traced
from .ransac import (MatchParams, MatchResult, _anchor_promote, _cos_sin,
                     _finish_match, _fma, _NN_Q, _NN_SAT, _pair_stats, _take,
                     hypothesis_uniforms, sample_hypotheses)

# Pairs and hypotheses per step of the plain twin: the fma emulation's
# float64 (512, 25, K, K) temporaries are 0.42 GB each at K=64.
_PAIR_CHUNK = 512
_HYP_CHUNK = 25
_MAX_K = 128           # kernels D, H, I and J (D, J: 7 index bits under the quantized distance)
_HYP_BLOCK = 32        # kernel D: hypotheses per block, grid (P, ceil(H/32))


def _features(a: MinutiaeSet, b: MinutiaeSet, wa, wb):
    """(P, 5, K) float32 feature planes x, y, orientation, type, weight of
    A and of B, with invalid slots displaced out of every gate."""
    def planes(ms, w, far):
        return torch.stack([
            torch.where(ms.valid, ms.xy[..., 0], far),
            torch.where(ms.valid, ms.xy[..., 1], far),
            ms.orientation, ms.minutia_type.to(torch.float32), w],
            dim=1).to(torch.float32).contiguous()
    return planes(a, wa, 1e6), planes(b, wb, -1e6)


def _gate_constants(p: MatchParams):
    sigma_d2 = 2.0 * (p.dist_thresh * 0.7) ** 2
    sigma_o2 = 2.0 * (p.orient_thresh * 0.7) ** 2
    return p.dist_thresh * p.dist_thresh, sigma_d2, sigma_o2


def hypothesis_scores_plain(a: MinutiaeSet, b: MinutiaeSet, wa, wb, theta, t,
                            has_cand, possible, p: MatchParams):
    """Plain PyTorch twin of kernel D. theta (P, H), t (P, H, 2), has_cand
    (P, H), possible (P,). Returns scores (P, H) float32 and counts (P, H)
    int32. Pairs go ``_PAIR_CHUNK`` and hypotheses ``_HYP_CHUNK`` at a
    time, which bounds the (pairs, hypotheses, K, K) temporaries whatever
    P is; every pair's result is its own."""
    pnum = theta.shape[0]
    if pnum > _PAIR_CHUNK:
        parts = [hypothesis_scores_plain(
            MinutiaeSet(*(x[s:s + _PAIR_CHUNK] for x in a)),
            MinutiaeSet(*(x[s:s + _PAIR_CHUNK] for x in b)),
            *(x[s:s + _PAIR_CHUNK] for x in (wa, wb, theta, t, has_cand,
                                             possible)), p)
            for s in range(0, pnum, _PAIR_CHUNK)]
        return (torch.cat([s for s, _ in parts]),
                torch.cat([c for _, c in parts]))
    fa, fb = _features(a, b, wa, wb)
    k = fa.shape[-1]
    dist2, sigma_d2, sigma_o2 = _gate_constants(p)
    col = torch.arange(k, dtype=torch.float32, device=fa.device)
    ax, ay = fa[:, 0, None], fa[:, 1, None]                      # (P, 1, K)
    bx, by = fb[:, 0, None, None], fb[:, 1, None, None]          # (P, 1, 1, K)
    scores, counts = [], []
    for h in range(0, theta.shape[1], _HYP_CHUNK):
        th = theta[:, h:h + _HYP_CHUNK, None]                    # (P, h, 1)
        c, s = _cos_sin(th)
        tax = _fma(c, ax, -(s * ay)) + t[:, h:h + _HYP_CHUNK, 0, None]
        tay = _fma(s, ax, c * ay) + t[:, h:h + _HYP_CHUNK, 1, None]
        dx = tax[..., None] - bx
        dy = tay[..., None] - by
        d2 = _fma(dx, dx, dy * dy)                               # (P, h, K, K)
        enc = torch.clamp(torch.round(d2 * _NN_Q), max=_NN_SAT) * float(k) + col
        encmin, j = torch.min(enc, dim=-1)
        d2_at = torch.floor(encmin / float(k)) / _NN_Q

        dang = fa[:, 2, None] + th - _take(fb[:, 2], j)
        dang = torch.abs(torch.remainder(dang + math.pi, 2.0 * math.pi)
                         - math.pi)
        inlier = (d2_at <= dist2) & (dang <= p.orient_thresh)
        if p.use_type:
            inlier &= torch.abs(fa[:, 3, None] - _take(fb[:, 3], j)) < 0.5
        sc = (torch.exp(-(d2_at / sigma_d2) - (dang * dang) / sigma_o2)
              * fa[:, 4, None] * _take(fb[:, 4], j))
        n = inlier.sum(dim=-1, dtype=torch.int32)
        raw = torch.where(inlier, sc, 0.0).sum(dim=-1) / (possible[:, None] + 1e-6)
        score = torch.clamp(torch.exp(0.75 * torch.log(torch.clamp(raw, min=1e-30))),
                            max=1.0)
        cand = has_cand[:, h:h + _HYP_CHUNK] > 0.5
        scores.append(torch.where((n >= p.min_inliers) & cand, score, 0.0))
        counts.append(torch.where(cand, n, 0))
    return torch.cat(scores, dim=1), torch.cat(counts, dim=1)


def _as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the kernel reads it; no copy (and no launch) when it already
    has the type and is contiguous, as the matcher's tensors are."""
    if x.dtype == dtype and x.is_contiguous():
        return x
    return x.to(dtype).contiguous()


# The (H, 2) uniforms of each (seed, ransac_iter, full_iters, device), kept
# on the device: a call reads them with no host draw and no blocking copy.
_UNIFORMS: dict = {}


def device_uniforms(p: MatchParams, device: torch.device) -> torch.Tensor:
    """``hypothesis_uniforms(p)`` on ``device``, uploaded by the first call
    for its (seed, ransac_iter, full_iters, device) and kept."""
    key = (p.seed, p.ransac_iter, p.full_iters, device)
    u = _UNIFORMS.get(key)
    if u is None:
        u = _UNIFORMS[key] = hypothesis_uniforms(p).to(device)
    return u


def cumsum_chunk(rows: int, k: int) -> int:
    """Leaves a block of the card's ``torch.cumsum`` scans at once along the
    last dimension of a (rows, k) tensor, as PyTorch's launcher picks it
    (``get_log_num_threads_x_inner_scan`` in ``ATen/native/cuda/
    ScanUtils.cuh``, unsigned arithmetic included); 0 for one row, which
    goes to cub's scan. Kernel I adds in the order this gives."""
    if rows == 1:
        return 0
    log_x, log_y = (k - 1).bit_length(), (rows - 1).bit_length()
    log_nx = ((9 + ((log_x - log_y) & 0xFFFFFFFF)) & 0xFFFFFFFF) // 2
    return 2 << min(max(4, log_nx), 9)


def sample_pairs_cuda(a: MinutiaeSet, b: MinutiaeSet, p: MatchParams):
    """Kernel I on CUDA tensors: one launch for the per-pair statistics and
    the sampled hypotheses; the same outputs as ``_pair_stats`` followed by
    ``sample_hypotheses``: (wa, wb, na, nb, possible, reject, theta, t,
    has_cand)."""
    pnum, k = a.valid.shape
    h = p.ransac_iter
    if k > _MAX_K or k & (k - 1):
        raise ValueError(f"K={k} must be a power of two <= {_MAX_K}")
    if a.xy.shape != (pnum, k, 2) or b.xy.shape != (pnum, k, 2) or any(
            x.shape != (pnum, k) for ms in (a, b) for x in ms[1:]):
        raise ValueError("inconsistent pair shapes")
    if pnum >= 2 ** 31 or not 0 <= h < 2 ** 31:
        raise ValueError(f"P={pnum} or H={h} out of range")
    dev = a.xy.device
    if dev.type != "cuda":
        raise ValueError(f"sample_pairs_cuda needs a CUDA tensor, got {dev}")
    if any(x.device != dev for x in (*a, *b)):
        raise ValueError("sample_pairs_cuda needs every tensor on one device")
    f32, i32 = torch.float32, torch.int32
    empty = lambda *s, dt=f32: torch.empty(s, dtype=dt, device=dev)
    out = (empty(pnum, k), empty(pnum, k), empty(pnum, dt=i32),
           empty(pnum, dt=i32), empty(pnum), empty(pnum, dt=torch.bool),
           empty(pnum, h), empty(pnum, h, 2), empty(pnum, h))
    if pnum == 0:
        return out
    types = (f32, i32, f32, f32, f32, f32, torch.bool)   # MinutiaeSet's order
    args = [_as(x, dt) for ms in (a, b) for x, dt in zip(ms, types)]
    args.append(device_uniforms(p, dev))
    rc = _build.load_library().mbfp_sample_hypotheses(
        *(x.data_ptr() for x in args), *(x.data_ptr() for x in out),
        pnum, h, k, cumsum_chunk(pnum, k), cumsum_chunk(pnum * h, k),
        _build.current_stream(a.xy))
    _build.check(rc, "mbfp_sample_hypotheses")
    count("kernel.sample")
    return out


def sample_pairs(a: MinutiaeSet, b: MinutiaeSet, p: MatchParams):
    """The per-pair statistics and the sampled hypotheses of (P, K) pairs:
    (wa, wb, na, nb, possible, reject, theta, t, has_cand). CPU tensors run
    ``_pair_stats`` (span ``match.stats``) then ``sample_hypotheses`` (span
    ``match.sample``); CUDA tensors launch kernel I inside ``match.sample``."""
    if a.xy.device.type == "cpu":
        with span("match.stats"):
            stats = _pair_stats(a, b)
        with span("match.sample"):
            return (*stats, *sample_hypotheses(a, b, stats[0], stats[1], p))
    with span("match.sample"):
        return sample_pairs_cuda(a, b, p)


def hypothesis_scores_cuda(a: MinutiaeSet, b: MinutiaeSet, wa, wb, theta, t,
                           has_cand, possible, p: MatchParams):
    """Kernel D on CUDA tensors; same contract as the plain twin."""
    if theta.device.type != "cuda":
        raise ValueError(
            f"hypothesis_scores_cuda needs a CUDA tensor, got {theta.device}")
    pnum, k = a.valid.shape
    h = theta.shape[1]
    if k > _MAX_K or k & (k - 1):
        raise ValueError(f"K={k} must be a power of two <= {_MAX_K}")
    if b.valid.shape != (pnum, k) or theta.shape != (pnum, h) \
            or t.shape != (pnum, h, 2) or has_cand.shape != (pnum, h) \
            or possible.shape != (pnum,) or wa.shape != (pnum, k) \
            or wb.shape != (pnum, k):
        raise ValueError("inconsistent pair/hypothesis shapes")
    if pnum >= 2 ** 31 or -(-h // _HYP_BLOCK) > 65535:
        raise ValueError(f"P={pnum} or H={h} out of range")
    scores = torch.empty((pnum, h), dtype=torch.float32, device=theta.device)
    counts = torch.empty((pnum, h), dtype=torch.int32, device=theta.device)
    if pnum == 0 or h == 0:
        return scores, counts
    f32 = torch.float32
    args = [_as(x, dt) for ms, w in ((a, wa), (b, wb))
            for x, dt in ((ms.xy, f32), (ms.orientation, f32),
                          (ms.minutia_type, torch.int32),
                          (ms.valid, torch.bool), (w, f32))]
    args += [_as(x, f32) for x in (theta, t, has_cand, possible)]
    dist2, sigma_d2, sigma_o2 = _gate_constants(p)
    rc = _build.load_library().mbfp_hypothesis_scores(
        *(x.data_ptr() for x in args), scores.data_ptr(), counts.data_ptr(),
        pnum, h, k, dist2, p.orient_thresh, sigma_d2, sigma_o2,
        int(bool(p.use_type)), int(p.min_inliers),
        _build.current_stream(theta))
    _build.check(rc, "mbfp_hypothesis_scores")
    count("kernel.match")
    return scores, counts


def hypothesis_scores(a: MinutiaeSet, b: MinutiaeSet, wa, wb, theta, t,
                      has_cand, possible, p: MatchParams):
    if theta.device.type == "cpu":
        return hypothesis_scores_plain(a, b, wa, wb, theta, t, has_cand,
                                       possible, p)
    return hypothesis_scores_cuda(a, b, wa, wb, theta, t, has_cand,
                                  possible, p)


def _recip32(x: float) -> float:
    """1 / x as the card divides a float32 tensor by the Python number x:
    the product with x's float32 reciprocal, taken in float32."""
    return float(np.float32(1.0) / np.float32(x))


def finish_match_cuda(a: MinutiaeSet, b: MinutiaeSet, wa, wb, possible, na,
                      nb, reject, h_score, h_n, h_theta, h_t,
                      p: MatchParams) -> MatchResult:
    """Kernel H on CUDA tensors: one launch for the whole finish; same
    contract as ``ransac._finish_match``."""
    pnum, k = a.valid.shape
    if k > _MAX_K or k & (k - 1):
        raise ValueError(f"K={k} must be a power of two <= {_MAX_K}")
    h = h_score.shape[-1]
    if b.valid.shape != (pnum, k) or a.xy.shape != (pnum, k, 2) \
            or b.xy.shape != (pnum, k, 2) or wa.shape != (pnum, k) \
            or wb.shape != (pnum, k) or h_score.shape != (pnum, h) \
            or h_n.shape != (pnum, h) or h_theta.shape != (pnum, h) \
            or h_t.shape != (pnum, h, 2) or any(
                x.shape != (pnum,) for x in (possible, na, nb, reject)):
        raise ValueError("inconsistent pair/hypothesis shapes")
    if pnum >= 2 ** 31 or (h == 0 and pnum):
        raise ValueError(f"P={pnum} or H={h} out of range")
    dev = h_score.device
    if dev.type != "cuda":
        raise ValueError(f"finish_match_cuda needs a CUDA tensor, got {dev}")
    if any(x.device != dev for x in (*a, *b, wa, wb, possible, na, nb, reject,
                                     h_n, h_theta, h_t)):
        raise ValueError("finish_match_cuda needs every tensor on one device")
    empty = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=dev)
    res = MatchResult(final_score=empty(pnum), inlier_ratio=empty(pnum),
                      n_inliers=empty(pnum, dt=torch.int32),
                      theta=empty(pnum), t=empty(pnum, 2))
    if pnum == 0:
        return res
    f32, i32 = torch.float32, torch.int32
    args = [_as(x, dt) for ms in (a, b)
            for x, dt in ((ms.xy, f32), (ms.orientation, f32),
                          (ms.minutia_type, i32), (ms.valid, torch.bool))]
    args += [_as(x, dt) for x, dt in (
        (wa, f32), (wb, f32), (possible, f32), (na, i32), (nb, i32),
        (reject, torch.bool), (h_score, f32), (h_n, i32), (h_theta, f32),
        (h_t, f32))]
    sigma_d, sigma_o = p.dist_thresh * 0.7, p.orient_thresh * 0.7
    rc = _build.load_library().mbfp_finish_match(
        *(x.data_ptr() for x in args), *(x.data_ptr() for x in res),
        pnum, h, k, p.dist_thresh, p.orient_thresh,
        _recip32(2.0 * sigma_d ** 2), _recip32(2.0 * sigma_o ** 2),
        p.stop_inlier_ratio, int(bool(p.use_type)), int(bool(p.cross_check)),
        _build.current_stream(h_score))
    _build.check(rc, "mbfp_finish_match")
    count("kernel.finish")
    return res


def finish_match(a: MinutiaeSet, b: MinutiaeSet, wa, wb, possible, na, nb,
                 reject, h_score, h_n, h_theta, h_t,
                 p: MatchParams) -> MatchResult:
    if h_score.device.type == "cpu":
        return _finish_match(a, b, wa, wb, possible, na, nb, reject, h_score,
                             h_n, h_theta, h_t, p)
    return finish_match_cuda(a, b, wa, wb, possible, na, nb, reject, h_score,
                             h_n, h_theta, h_t, p)


@traced("match.batch")
def match_pairs_batch(a: MinutiaeSet, b: MinutiaeSet,
                      p: MatchParams = MatchParams()) -> MatchResult:
    """Batched 1:1 matching of (P, K) MinutiaeSets, the full pass:
    statistics and sampling (kernel I on a CUDA device), hypothesis scoring
    (kernel D on a CUDA device), then the finish (selection, Kabsch refine,
    cross-check; kernel H on a CUDA device). Spans, under ``match.batch``:
    ``match.stats`` (CPU only), ``match.sample``, ``match.score`` and
    ``match.finish``; counts ``match.pairs``."""
    count("match.pairs", a.valid.shape[0])
    wa, wb, na, nb, possible, reject, theta, t, cand = sample_pairs(a, b, p)
    with span("match.score"):
        scores, counts = hypothesis_scores(a, b, wa, wb, theta, t, cand,
                                           possible, p)
    with span("match.finish"):
        return finish_match(a, b, wa, wb, possible, na, nb, reject, scores,
                            counts, theta, t, p)


# The counterpart of the JAX package's ``match_pairs_batch_pallas``.
match_pairs_batch_kernel = match_pairs_batch


def match_minutiae_pair(a: MinutiaeSet, b: MinutiaeSet,
                        p: MatchParams = MatchParams()) -> MatchResult:
    """1:1 match of two (K,) minutiae sets: the P=1 case of
    ``match_pairs_batch``."""
    r = match_pairs_batch(MinutiaeSet(*(x[None] for x in a)),
                          MinutiaeSet(*(x[None] for x in b)), p)
    return MatchResult(*(x[0] for x in r))


def _screen(a: MinutiaeSet, b: MinutiaeSet, p: MatchParams):
    """The sampled screen of (P,) pairs and the statistics it sampled with:
    (hit, wa, wb, reject). A pair's hit is set when any hypothesis scores
    above 0 or reaches ``p.min_inliers`` (the caller relaxes it), minus the
    early rejects the full pass would zero anyway. No finish.

    At equal hypothesis budget every pair the full pass scores above 0 is
    promoted. With ``p.full_iters`` at the full budget the screen's
    hypotheses are a prefix of the full pass's, so a miss can only be a
    pair whose good transforms all lie in the tail. Spans as
    ``match_pairs_batch``'s, without ``match.finish``."""
    wa, wb, _, _, possible, reject, theta, t, cand = sample_pairs(a, b, p)
    with span("match.score"):
        scores, counts = hypothesis_scores(a, b, wa, wb, theta, t, cand,
                                           possible, p)
    hit = ((scores.amax(dim=-1) > 0.0)
           | (counts.amax(dim=-1) >= p.min_inliers))
    return hit & ~reject, wa, wb, reject


def anchor_pairs_cuda(a: MinutiaeSet, b: MinutiaeSet, wa, wb, reject,
                      p: MatchParams) -> torch.Tensor:
    """Kernel J on CUDA tensors: one launch for the recall anchors of (P, K)
    pairs given their statistics; same contract as
    ``ransac._anchor_promote``."""
    pnum, k = a.valid.shape
    if k > _MAX_K or k & (k - 1):
        raise ValueError(f"K={k} must be a power of two <= {_MAX_K}")
    if a.xy.shape != (pnum, k, 2) or b.xy.shape != (pnum, k, 2) or any(
            x.shape != (pnum, k) for x in (a.orientation, a.minutia_type,
                                           b.orientation, b.minutia_type,
                                           b.valid, wa, wb)) \
            or reject.shape != (pnum,):
        raise ValueError("inconsistent pair shapes")
    if pnum >= 2 ** 31:
        raise ValueError(f"P={pnum} out of range")
    dev = a.xy.device
    if dev.type != "cuda":
        raise ValueError(f"anchor_pairs_cuda needs a CUDA tensor, got {dev}")
    if any(x.device != dev for x in (*a, *b, wa, wb, reject)):
        raise ValueError("anchor_pairs_cuda needs every tensor on one device")
    out = torch.empty(pnum, dtype=torch.bool, device=dev)
    if pnum == 0:
        return out
    f32, i32 = torch.float32, torch.int32
    args = [_as(x, dt) for ms in (a, b)
            for x, dt in ((ms.xy, f32), (ms.orientation, f32),
                          (ms.minutia_type, i32), (ms.valid, torch.bool))]
    args += [_as(wa, f32), _as(wb, f32), _as(reject, torch.bool)]
    rc = _build.load_library().mbfp_anchor_promote(
        *(x.data_ptr() for x in args), out.data_ptr(), pnum, k,
        p.dist_thresh, p.orient_thresh, int(bool(p.use_type)),
        int(p.min_inliers), _build.current_stream(a.xy))
    _build.check(rc, "mbfp_anchor_promote")
    count("kernel.anchor")
    return out


@traced("match.anchor")
def anchor_pairs(a: MinutiaeSet, b: MinutiaeSet, wa, wb, reject,
                 p: MatchParams) -> torch.Tensor:
    """The screen's recall anchors of (P, K) pairs given their weights and
    early reject (``sample_pairs``' ``wa``, ``wb``, ``reject``): CPU tensors
    run ``ransac._anchor_promote``, CUDA tensors launch kernel J; span
    ``match.anchor``."""
    if a.xy.device.type == "cpu":
        return _anchor_promote(a, b, wa, wb, reject, p)
    return anchor_pairs_cuda(a, b, wa, wb, reject, p)


def screen_promote_batch(a: MinutiaeSet, b: MinutiaeSet, p: MatchParams,
                         anchors: bool = True) -> torch.Tensor:
    """Cascade-screen promote bits for (P,) pairs: the sampled screen
    (``_screen``) OR-ed with the recall anchors
    (``ransac.anchor_promote``; ``anchor_pairs``, kernel J on a card),
    which read the statistics the screen sampled with: one ``sample_pairs``
    a call. The one screen every cascade call site shares (pair-index
    matching and the gallery's pair-list and blocked screens), so their
    promotion sets stay identical. ``anchors=False`` is the ablation switch
    that measures the sampled screen alone. Spans ``match.batch`` (the
    sampled screen's) then ``match.anchor``.

    This is the JAX package's accelerator rule. Its CPU route
    (``use_pallas=False``) screens with the full matcher instead; the port
    has the one rule on every device."""
    with span("match.batch"):
        base, wa, wb, reject = _screen(a, b, p)
    return base | anchor_pairs(a, b, wa, wb, reject, p) if anchors else base
