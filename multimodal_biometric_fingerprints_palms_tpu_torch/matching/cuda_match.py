"""RANSAC hypothesis scoring: kernel D (``csrc/match.cu``) and its plain twin,
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

``hypothesis_scores`` dispatches on the device: CPU tensors run
``hypothesis_scores_plain``, CUDA tensors launch the kernel; anything else
raises. Every matcher entry point scores through it, so there is one
scoring route on every device: the JAX package's XLA route
(``ransac.match_pairs_batch``, ``raw ** 0.75``) and its Pallas route
compute the same results within the tests' tolerances, and the port
reproduces the Pallas kernels' formula.
"""

from __future__ import annotations

import math

import torch

from ..features.minutiae import MinutiaeSet
from ..kernels import build as _build
from ..utils.profiling import count, span, traced
from .ransac import (MatchParams, MatchResult, _cos_sin, _finish_match, _fma,
                     _NN_Q, _NN_SAT, _pair_stats, _take, anchor_promote,
                     sample_hypotheses)

# Pairs and hypotheses per step of the plain twin: the fma emulation's
# float64 (512, 25, K, K) temporaries are 0.42 GB each at K=64.
_PAIR_CHUNK = 512
_HYP_CHUNK = 25
_MAX_K = 128           # kernel D: 7 index bits under the quantized distance
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


@traced("match.batch")
def match_pairs_batch(a: MinutiaeSet, b: MinutiaeSet,
                      p: MatchParams = MatchParams()) -> MatchResult:
    """Batched 1:1 matching of (P, K) MinutiaeSets, the full pass:
    sampling, hypothesis scoring (kernel D on a CUDA device), then the
    finish (selection, Kabsch refine, cross-check). Spans, under
    ``match.batch``: ``match.stats``, ``match.sample``, ``match.score``
    and ``match.finish``; counts ``match.pairs``."""
    count("match.pairs", a.valid.shape[0])
    with span("match.stats"):
        wa, wb, na, nb, possible, reject = _pair_stats(a, b)
    with span("match.sample"):
        theta, t, cand = sample_hypotheses(a, b, wa, wb, p)
    with span("match.score"):
        scores, counts = hypothesis_scores(a, b, wa, wb, theta, t, cand,
                                           possible, p)
    with span("match.finish"):
        return _finish_match(a, b, wa, wb, possible, na, nb, reject,
                             scores, counts, theta, t, p)


# The counterpart of the JAX package's ``match_pairs_batch_pallas``.
match_pairs_batch_kernel = match_pairs_batch


def match_minutiae_pair(a: MinutiaeSet, b: MinutiaeSet,
                        p: MatchParams = MatchParams()) -> MatchResult:
    """1:1 match of two (K,) minutiae sets: the P=1 case of
    ``match_pairs_batch``."""
    r = match_pairs_batch(MinutiaeSet(*(x[None] for x in a)),
                          MinutiaeSet(*(x[None] for x in b)), p)
    return MatchResult(*(x[0] for x in r))


@traced("match.batch")
def screen_pairs_batch_kernel(a: MinutiaeSet, b: MinutiaeSet,
                              p: MatchParams) -> torch.Tensor:
    """Cascade screen, (P,) bool: promote a pair when any hypothesis scores
    above 0 or reaches ``p.min_inliers`` (the caller relaxes it), minus the
    early rejects the full pass would zero anyway. No finish.

    At equal hypothesis budget every pair the full pass scores above 0 is
    promoted. With ``p.full_iters`` at the full budget the screen's
    hypotheses are a prefix of the full pass's, so a miss can only be a
    pair whose good transforms all lie in the tail. Spans as
    ``match_pairs_batch``'s, without ``match.finish``."""
    with span("match.stats"):
        wa, wb, _, _, possible, reject = _pair_stats(a, b)
    with span("match.sample"):
        theta, t, cand = sample_hypotheses(a, b, wa, wb, p)
    with span("match.score"):
        scores, counts = hypothesis_scores(a, b, wa, wb, theta, t, cand,
                                           possible, p)
    hit = ((scores.amax(dim=-1) > 0.0)
           | (counts.amax(dim=-1) >= p.min_inliers))
    return hit & ~reject


def screen_promote_batch(a: MinutiaeSet, b: MinutiaeSet, p: MatchParams,
                         anchors: bool = True) -> torch.Tensor:
    """Cascade-screen promote bits for (P,) pairs: the sampled screen
    (``screen_pairs_batch_kernel``) OR-ed with ``ransac.anchor_promote``.
    The one screen every cascade call site shares (pair-index matching and
    the gallery's pair-list and blocked screens), so their promotion sets
    stay identical. ``anchors=False`` is the ablation switch that measures
    the sampled screen alone.

    This is the JAX package's accelerator rule. Its CPU route
    (``use_pallas=False``) screens with the full matcher instead; the port
    has the one rule on every device."""
    base = screen_pairs_batch_kernel(a, b, p)
    return base | anchor_promote(a, b, p) if anchors else base
