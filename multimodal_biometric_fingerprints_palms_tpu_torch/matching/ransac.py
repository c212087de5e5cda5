"""RANSAC rigid-transform minutiae matching (port of ``matching/ransac.py``).

The JAX package vmaps one pair's H hypotheses and vmaps again over pairs;
here both are explicit leading dimensions. ``a`` and ``b`` are (P, K)
MinutiaeSets, hypotheses are (P, H) tensors, and a nearest-neighbour
selection is an index tensor read with gathers (the JAX package's one-hot
contractions replaced gathers on the TPU; on the card a gather is cheap).

Semantics are the JAX package's, term by term: descriptor weights, the
early rejects (< 8 minutiae, spatial-std mismatch > 35), weight-
proportional hypothesis sampling from one pair-independent uniform draw
(``threefry.uniform``, equal to ``jax.random.uniform``), the quantized
unique-min nearest neighbour (``_NN_Q``), the deterministic early stop or
best score, the closed-form Kabsch refine, the spread-consistency reject,
the mutual-nearest cross-check and the 0.25 final exponent.

This module is the matcher's tensor code. The batch entry points
(``match_pairs_batch``, ``match_minutiae_pair``, ``screen_promote_batch``)
sit in ``cuda_match`` beside hypothesis-scoring kernel D, the one scoring
route on every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..features.minutiae import MinutiaeSet
from ..utils import threefry
from ..utils.profiling import traced

_BIG = 1e9


class MatchParams(NamedTuple):
    dist_thresh: float = 10.0
    orient_thresh: float = math.radians(12.0)
    use_type: bool = True
    ransac_iter: int = 300
    min_inliers: int = 8
    stop_inlier_ratio: float = 0.25
    cross_check: bool = True
    seed: int = 42
    # When > ransac_iter, uniforms are drawn at this length and the first
    # ransac_iter rows used — so a cascade screen's hypotheses are a true
    # prefix of the full pass's (same seed, same sequence).
    full_iters: int = 0


class MatchResult(NamedTuple):
    final_score: torch.Tensor   # (P,) in [0, 1]
    inlier_ratio: torch.Tensor
    n_inliers: torch.Tensor     # (P,) int32
    theta: torch.Tensor
    t: torch.Tensor             # (P, 2)


def compute_descriptor_weights(ms: MinutiaeSet) -> torch.Tensor:
    """(…, K) weights clip(type_bonus * (0.5q + 0.3coh + 0.2angs), 0.05, 2)
    with bifurcation bonus 1.25; invalid slots get 0."""
    type_bonus = torch.where(ms.minutia_type == 1, 1.25, 1.0)
    base = 0.5 * ms.quality + 0.3 * ms.coherence + 0.2 * ms.angular_stability
    w = torch.clamp(type_bonus * base, 0.05, 2.0)
    return torch.where(ms.valid, w, 0.0)


def _cos_sin(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 cos and sin rounded from float64: one result on every device
    (PyTorch's float32 cos differs between the CPU and the card by an ulp
    in a few percent of inputs, and an ulp can move a quantized distance)."""
    th = theta.to(torch.float64)
    return torch.cos(th).to(torch.float32), torch.sin(th).to(torch.float32)


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2 rounded from float64, as ``_cos_sin``. PyTorch's
    float32 atan2 (and ``**``) on the CPU also differs by an ulp between
    its vectorized loop and its scalar tail, so on (P,) tensors a pair's
    result would depend on the size of the batch it is matched in."""
    return torch.atan2(y.to(torch.float64),
                       x.to(torch.float64)).to(torch.float32)


def _sum64(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float64 sum of float32 terms. The card and the CPU add in different
    orders; in float64 the order moves a sum of <= K float32 terms far below
    a float32 ulp, so what the finish derives from it (centroids, the
    refined angle, the final score) is one result on both."""
    return x.to(torch.float64).sum(dim=dim)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add.

    The JAX package's CPU results come from XLA, which contracts a*b + c*d
    into fma(a, b, c*d) (or fma(c, d, a*b) in a reduction), and a last-bit
    difference in a distance can move its 1/256 px^2 quantization step. The
    port states each contraction XLA makes, and kernel D uses ``__fmaf_rn``
    at the same places, so the CPU and the card round alike. Emulated in
    float64: the product is exact, the sum is rounded to odd (TwoSum gives
    its error), and the final rounding to float32 is then correct."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    inexact_even = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, math.inf), e)
    return torch.where(inexact_even, torch.nextafter(s, toward),
                       s).to(torch.float32)


def _apply_rigid(pts, theta, t):
    """Rotate (…, 2) points by ``theta`` (broadcast against pts[..., 0])
    and translate by ``t``."""
    c, s = _cos_sin(theta)
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([_fma(c, x, -(s * y)), _fma(s, x, c * y)], dim=-1) + t


def _angle_diff(a, b):
    d = a - b
    return torch.remainder(d + math.pi, 2.0 * math.pi) - math.pi


def _sqdist(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """(…, Ka, Kb) squared distances in the JAX package's matmul form
    |a|^2 - 2 a.b + |b|^2, clamped at 0, with the two-term contractions
    written out as fused multiply-adds."""
    ax, ay = pa[..., :, None, 0], pa[..., :, None, 1]
    bx, by = pb[..., None, :, 0], pb[..., None, :, 1]
    aa = _fma(ay, ay, ax * ax)
    bb = _fma(by, by, bx * bx)
    ab = _fma(ay, by, ax * bx)
    return torch.clamp(aa - 2.0 * ab + bb, min=0.0)


# Quantized nearest-neighbour tie-break of the JAX package, which defines
# its outputs: encode = round(d2 * NN_Q) * K + j. The j term makes the
# encoded min unique. Exact in f32: (2^18 - 1) * 64 + 63 < 2^24. Saturated
# entries (d2 >= 1024 px^2) are beyond every gate.
_NN_Q = 256.0
_NN_SAT = float(2 ** 18 - 1)


def _nn_encode(d2: torch.Tensor) -> torch.Tensor:
    """(…, K) -> (…, K) unique-min encoding round(d2*Q)*K + j."""
    k = d2.shape[-1]
    d2q = torch.clamp(torch.round(d2 * _NN_Q), max=_NN_SAT)
    col = torch.arange(k, dtype=torch.float32, device=d2.device)
    return d2q * float(k) + col


def _nn_select(d2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(j*, d2_at): each row's quantized-first argmin (the index the JAX
    package's one-hot rows select) and its quantized squared distance,
    decoded arithmetically from the encoded min."""
    k = d2.shape[-1]
    encmin, j = torch.min(_nn_encode(d2), dim=-1)
    return j, torch.floor(encmin / float(k)) / _NN_Q


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, K) or (P, K, 2) read at idx (P, ...) along K, per pair."""
    rows = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[rows, idx]


def _match_with_transform(a: MinutiaeSet, b: MinutiaeSet, wa, wb, theta, t,
                          p: MatchParams):
    """Score every A slot under each of the (P, H) hypotheses ``theta``,
    ``t`` (P, H, 2). Returns (scores, inlier, nn), each (P, H, K); nn[.., i]
    is the index of A minutia i's nearest neighbour in B."""
    ta = _apply_rigid(a.xy[:, None], theta[..., None], t[..., None, :])
    d2 = _sqdist(ta, b.xy[:, None])                          # (P, H, K, K)
    d2 = torch.where(b.valid[:, None, None, :], d2, _BIG)    # mask invalid B
    nn, d2_at = _nn_select(d2)
    d = torch.sqrt(d2_at)

    ang_err = torch.abs(_angle_diff(a.orientation[:, None] + theta[..., None],
                                    _take(b.orientation, nn)))
    inlier = (a.valid[:, None] & (d <= p.dist_thresh)
              & (ang_err <= p.orient_thresh))
    if p.use_type:
        inlier &= a.minutia_type[:, None] == _take(b.minutia_type, nn)

    sigma_d = p.dist_thresh * 0.7
    sigma_o = p.orient_thresh * 0.7
    spatial = torch.exp(-(d * d) / (2.0 * sigma_d ** 2))
    orient_f = torch.exp(-(ang_err * ang_err) / (2.0 * sigma_o ** 2))
    scores = torch.where(inlier, spatial * orient_f * wa[:, None]
                         * _take(wb, nn), 0.0)
    return scores, inlier, nn


def hypothesis_uniforms(p: MatchParams) -> torch.Tensor:
    """(H, 2) float32 uniforms driving hypothesis sampling (CPU tensor),
    equal to the JAX package's ``jax.random.uniform(PRNGKey(seed), ...)``.
    Pair-independent, like the reference's seed series. When
    ``p.full_iters > p.ransac_iter`` (the cascade's screen pass) the draw is
    made at the full length and cut, so the screen's hypotheses are the
    first ``ransac_iter`` of the full pass's."""
    n = max(p.full_iters, p.ransac_iter)
    return torch.from_numpy(threefry.uniform(p.seed, (n, 2))[:p.ransac_iter])


def _first_hit(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index of the first position where cdf (…, K) exceeds u (…, 1):
    inverse-CDF sampling. When u*total rounds up to total in f32 no entry
    exceeds it; the ``cdf >= total`` term then takes the last positive-
    weight index, as the JAX package does."""
    sel = (cdf > u) | (cdf >= cdf[..., -1:])
    return torch.argmax(sel.to(torch.uint8), dim=-1)


def sample_hypotheses(a: MinutiaeSet, b: MinutiaeSet, wa, wb,
                      p: MatchParams, u: torch.Tensor | None = None):
    """Weight-proportional rigid-hypothesis sampling for P pairs at once:
    pick a in A ∝ w, pick b among same-type B candidates ∝ w, hypothesis =
    (theta, t) aligning them. Returns theta (P, H), t (P, H, 2) and
    has_cand (P, H) float32."""
    if u is None:
        u = hypothesis_uniforms(p)
    u = u.to(a.xy.device)
    wa_v = torch.where(a.valid, wa, 0.0)
    ca = torch.cumsum(wa_v, dim=-1)                              # (P, K)
    ia = _first_hit(ca[:, None, :], u[None, :, 0:1] * ca[:, -1:, None])
    atype_s = _take(a.minutia_type, ia)                          # (P, H)
    aori_s = _take(a.orientation, ia)
    axy_s = _take(a.xy, ia)                                      # (P, H, 2)

    wb_v = torch.where(b.valid, wb, 0.0)
    cand_w = torch.where(b.minutia_type[:, None, :] == atype_s[..., None],
                         wb_v[:, None, :], 0.0)                  # (P, H, K)
    cb = torch.cumsum(cand_w, dim=-1)
    total_b = cb[..., -1:]
    has_cand = total_b[..., 0] > 0.0
    ib = _first_hit(cb, u[None, :, 1:2] * total_b)
    bori_s = _take(b.orientation, ib)
    bxy_s = _take(b.xy, ib)

    theta = _angle_diff(bori_s, aori_s)
    t = bxy_s - _apply_rigid(axy_s, theta, 0.0)
    return theta, t, has_cand.to(torch.float32)


def _masked_mean(x, m, dim):
    """float32 mean of ``x`` where ``m``, summed in float64 (``_sum64``)."""
    num = _sum64(torch.where(m, x, 0.0), dim)
    den = torch.clamp(m.expand_as(x).sum(dim=dim), min=1)
    return (num / den).to(torch.float32)


def _spatial_std(ms: MinutiaeSet) -> torch.Tensor:
    """(P, 2) standard deviation of the valid minutiae's coordinates."""
    m = ms.valid[..., None]
    dev = ms.xy - _masked_mean(ms.xy, m, dim=-2)[..., None, :]
    return torch.sqrt(_masked_mean(dev * dev, m, dim=-2))


def _pair_stats(a: MinutiaeSet, b: MinutiaeSet):
    """Per-pair quantities every matcher stage shares: weights, counts,
    ``possible`` = min(sum wa, sum wb), and the early rejects (< 8 minutiae
    either side, spatial-std mismatch > 35)."""
    wa = compute_descriptor_weights(a)
    wb = compute_descriptor_weights(b)
    na = a.valid.sum(dim=-1, dtype=torch.int32)
    nb = b.valid.sum(dim=-1, dtype=torch.int32)
    possible = torch.minimum(_sum64(wa, -1), _sum64(wb, -1)).to(torch.float32)
    dstd = _spatial_std(a) - _spatial_std(b)
    reject = ((na < 8) | (nb < 8)
              | (torch.sqrt((dstd * dstd).sum(dim=-1)) > 35.0))
    return wa, wb, na, nb, possible, reject


@traced("match.anchor")
def anchor_promote(a: MinutiaeSet, b: MinutiaeSet, p: MatchParams,
                   n_anchors: int = 8) -> torch.Tensor:
    """(P,) deterministic recall-only anchors for the cascade screen.

    Pairs the t-th highest-weight minutia of A with the t-th of B for
    t < ``n_anchors`` (ties to the lower index, as ``lax.top_k``), scores
    each transform with the screen's inlier gate, and promotes a pair if
    any valid anchor reaches ``min_inliers``. OR-ed into the sampled screen
    it only ever promotes more pairs; the early rejects still gate it."""
    wa, wb, _, _, _, reject = _pair_stats(a, b)

    def top(ms, w):
        key = torch.where(ms.valid, w, -1.0)
        idx = torch.sort(key, dim=-1, descending=True,
                         stable=True).indices[:, :n_anchors]
        return (_take(ms.orientation, idx), _take(ms.xy, idx),
                _take(ms.valid, idx))

    ori_a, xy_a, valid_a = top(a, wa)
    ori_b, xy_b, valid_b = top(b, wb)
    theta = _angle_diff(ori_b, ori_a)                            # (P, T)
    t = xy_b - _apply_rigid(xy_a, theta, 0.0)
    _, inlier, _ = _match_with_transform(a, b, wa, wb, theta, t, p)
    counts = inlier.sum(dim=-1)
    return ((valid_a & valid_b & (counts >= p.min_inliers)).any(dim=-1)
            & ~reject)


def _finish_match(a: MinutiaeSet, b: MinutiaeSet, wa, wb, possible, na, nb,
                  reject, h_score, h_n, h_theta, h_t,
                  p: MatchParams) -> MatchResult:
    """Selection + Kabsch refine + cross-check + final score for (P,) pairs
    given their (P, H) hypothesis scores, counts and transforms."""
    h_score = torch.where(reject[:, None], 0.0, h_score)
    h_n = torch.where(reject[:, None], 0, h_n)
    rows = torch.arange(h_score.shape[0], device=h_score.device)

    # Deterministic early-stop-or-best selection: the first hypothesis that
    # reaches the stop count with a positive score, else the best score.
    stop_count = p.stop_inlier_ratio * torch.minimum(na, nb).to(torch.float32)
    reached = (h_n.to(torch.float32) >= stop_count[:, None]) & (h_score > 0.0)
    best_h = torch.where(reached.any(dim=-1),
                         torch.argmax(reached.to(torch.uint8), dim=-1),
                         torch.argmax(h_score, dim=-1))
    best_score = h_score[rows, best_h]
    theta0, t0 = h_theta[rows, best_h], h_t[rows, best_h]

    # Kabsch refinement on the best hypothesis's inliers, closed form for
    # the 2x2 case: theta* = atan2(H01 - H10, H00 + H11).
    _, inl0, nn0 = _match_with_transform(a, b, wa, wb, theta0[:, None],
                                         t0[:, None], p)
    inl0, nn0 = inl0[:, 0], nn0[:, 0]
    m = inl0[..., None]
    pa = a.xy
    pb = _take(b.xy, nn0)
    ca = _masked_mean(pa, m, dim=-2)
    cb = _masked_mean(pb, m, dim=-2)
    A = (pa - ca[:, None]) * m.to(torch.float32)
    B = (pb - cb[:, None]) * m.to(torch.float32)
    h00 = _sum64(A[..., 0] * B[..., 0], -1)
    h01 = _sum64(A[..., 0] * B[..., 1], -1)
    h10 = _sum64(A[..., 1] * B[..., 0], -1)
    h11 = _sum64(A[..., 1] * B[..., 1], -1)
    theta_r = _atan2(h01 - h10, h00 + h11)
    t_r = cb - _apply_rigid(ca, theta_r, 0.0)

    # Re-match with the refined transform.
    scores_r, inl_r, nn_r = _match_with_transform(
        a, b, wa, wb, theta_r[:, None], t_r[:, None], p)
    scores_r, inl_r, nn_r = scores_r[:, 0], inl_r[:, 0], nn_r[:, 0]
    n_r = inl_r.sum(dim=-1)

    # Spread-consistency reject.
    def spread(pts):
        mu = _masked_mean(pts, inl_r[..., None], dim=-2)
        dev = pts - mu[:, None]
        return _masked_mean(torch.sqrt((dev * dev).sum(dim=-1)), inl_r, dim=-1)

    spread_bad = (n_r >= 8) & (torch.abs(spread(pa) - spread(_take(b.xy, nn_r)))
                               > 18.0)
    scored = best_score > 0.0
    ok = scored & ~spread_bad
    theta_f = torch.where(scored, theta_r, 0.0)
    t_f = torch.where(scored[:, None], t_r, 0.0)

    # Mutual-nearest cross-check: A minutia i survives when the nearest A
    # (under the final transform) of its nearest B is i itself.
    if p.cross_check:
        ta = _apply_rigid(a.xy, theta_f[:, None], t_f[:, None])
        d2_ba = _sqdist(b.xy, ta)
        d2_ba = torch.where(a.valid[:, None, :], d2_ba, _BIG)
        nn_ba, _ = _nn_select(d2_ba)                             # (P, K) B -> A
        iota = torch.arange(nn_r.shape[-1], device=nn_r.device)
        inl_f = inl_r & (_take(nn_ba, nn_r) == iota)
    else:
        inl_f = inl_r
    inl_f = inl_f & ok[:, None]
    scores_f = torch.where(inl_f, scores_r, 0.0)

    n_f = inl_f.sum(dim=-1, dtype=torch.int32)
    raw = _sum64(scores_f, -1) / (possible.to(torch.float64) + 1e-6)
    final_score = torch.clamp((raw ** 0.25).to(torch.float32), 0.0, 1.0)
    inlier_ratio = n_f.to(torch.float32) / torch.clamp(
        torch.minimum(na, nb).to(torch.float32), min=1.0)
    return MatchResult(final_score=final_score, inlier_ratio=inlier_ratio,
                       n_inliers=n_f, theta=theta_f, t=t_f)
