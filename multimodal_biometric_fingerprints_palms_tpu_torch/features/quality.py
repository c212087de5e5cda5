"""Minutiae quality enrichment + adaptive NMS + orientation dedup (port of
``features/quality.py``).

Per-minutia scoring vectorises over the K slots and the batch; the two
sequential suppression passes are Python loops over K with the batch as a
tensor dimension, reproducing the reference's visit order (including its
last-writer-wins NMS quirk). Both sorts are stable, as ``jnp.argsort`` is:
quality-0 ties decide the visit order.
"""

from __future__ import annotations

import math

import torch

from ..ops.filters import blur_mean
from ..ops.orientation import compute_orientation_field
from ..utils.profiling import span, traced
from .minutiae import MinutiaeSet


def _at(field: torch.Tensor, yc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """field (B, H, W) sampled at (B, K) integer coordinates."""
    b, h, w = field.shape
    return torch.gather(field.reshape(b, h * w), 1, yc * w + xc)


def _coords(ms: MinutiaeSet, h: int, w: int):
    x = ms.xy[..., 0].to(torch.int64)
    y = ms.xy[..., 1].to(torch.int64)
    return x, y, torch.clamp(x, 0, w - 1), torch.clamp(y, 0, h - 1)


def _enrich(ms: MinutiaeSet, skel: torch.Tensor, density: torch.Tensor,
            orient: torch.Tensor, coherence: torch.Tensor,
            quality_threshold: float, coherence_threshold: float,
            margin: int, patch_radius: int) -> MinutiaeSet:
    """Quality scoring for a (B, K) batch of minutiae on (B, H, W) maps."""
    h, w = skel.shape[-2:]
    x, y, xc, yc = _coords(ms, h, w)
    in_margin = (x >= margin) & (x < w - margin) & (y >= margin) & (y < h - margin)

    local_coh = _at(coherence, yc, xc)
    local_den = _at(density, yc, xc)
    gates = (local_den >= quality_threshold) & (local_coh >= coherence_threshold)
    ang = _at(orient, yc, xc)

    # angular stability: std over the (2r x 2r) orientation patch, from two
    # box filters (E[x^2] - E[x]^2) sampled at the minutiae
    pr = patch_radius
    mean = blur_mean(orient, 2 * pr)
    sqmean = blur_mean(orient * orient, 2 * pr)
    var = torch.clamp(sqmean - mean * mean, min=0.0)
    stds = _at(torch.sqrt(var), yc, xc)
    angular_stability = torch.exp(-3.0 * stds)

    xf, yf = x.to(torch.float32), y.to(torch.float32)
    # tensor divisors: a true division on every device (h / 2 is no power
    # of two; see ops.cuda_kernels.bin_to_unit)
    half_w = torch.full((), w / 2.0, device=xf.device)
    half_h = torch.full((), h / 2.0, device=xf.device)
    center_bonus = 1.0 - 0.5 * (
        (torch.abs(xf - w / 2.0) / half_w) ** 2
        + (torch.abs(yf - h / 2.0) / half_h) ** 2
    )
    local_intensity = _at(skel, yc, xc)

    score = (0.5 * local_coh + 0.25 * local_den
             + 0.1 * angular_stability + 0.1 * local_intensity) * center_bonus

    valid = ms.valid & in_margin & gates
    return ms._replace(
        orientation=ang,
        quality=torch.where(valid, score, torch.zeros_like(score)),
        coherence=local_coh,
        angular_stability=angular_stability,
        valid=valid,
    )


def _pair_d2(xy: torch.Tensor) -> torch.Tensor:
    return ((xy[:, :, None, :] - xy[:, None, :, :]) ** 2).sum(dim=-1)


def _nms_adaptive(ms: MinutiaeSet, density: torch.Tensor, base_dist: float,
                  h: int, w: int) -> torch.Tensor:
    """Quality-ordered adaptive NMS; returns the surviving-validity mask.
    Visiting a point marks it kept and suppresses everything inside its
    adaptive ball (last writer wins)."""
    bsz, k = ms.valid.shape
    _, _, xc, yc = _coords(ms, h, w)
    radius = base_dist / (0.5 + _at(density, yc, xc))
    d2 = _pair_d2(ms.xy)
    eye = torch.eye(k, dtype=torch.bool, device=ms.valid.device)
    order = torch.argsort(-ms.quality, dim=-1, stable=True)
    rows = torch.arange(bsz, device=ms.valid.device)

    keep = torch.zeros((bsz, k), dtype=torch.bool, device=ms.valid.device)
    for t in range(k):
        i = order[:, t]
        r_i = radius[rows, i]
        ball = (d2[rows, i] <= (r_i ** 2)[:, None]) & ~eye[i] & ms.valid
        visited = keep & ~ball
        visited[rows, i] = True
        keep = torch.where(ms.valid[rows, i][:, None], visited, keep)
    return keep & ms.valid


def _remove_redundant_oriented(ms: MinutiaeSet, keep: torch.Tensor,
                               density: torch.Tensor, base_radius: float,
                               angle_thresh: float, h: int, w: int
                               ) -> torch.Tensor:
    """Pairwise orientation dedup: visit i in extraction order; within i's
    adaptive radius, near-parallel pairs drop the lower-quality member."""
    k = ms.valid.shape[-1]
    _, _, xc, yc = _coords(ms, h, w)
    radius = base_radius * (1.0 + (1.0 - ms.quality)) / (0.5 + _at(density, yc, xc))
    d2 = _pair_d2(ms.xy)
    dang = ms.orientation[:, :, None] - ms.orientation[:, None, :]
    ang_close = torch.abs(torch.atan2(torch.sin(dang), torch.cos(dang))) < angle_thresh
    cols = torch.arange(k, device=keep.device)

    removed = torch.zeros_like(keep)
    for i in range(k):
        cond = ((cols > i)[None, :]
                & keep[:, i:i + 1] & keep
                & ~removed[:, i:i + 1] & ~removed
                & (d2[:, i] <= (radius[:, i] ** 2)[:, None])
                & ang_close[:, i])
        i_loses = ms.quality[:, i:i + 1] < ms.quality
        remove_i = (cond & i_loses).any(dim=-1)
        removed = removed | (cond & ~i_loses)
        removed[:, i] = removed[:, i] | remove_i
    return keep & ~removed


def _sort_and_cap(ms: MinutiaeSet, max_minutiae: int) -> MinutiaeSet:
    """Final quality-descending sort + cap."""
    k = ms.valid.shape[-1]
    inf = torch.full_like(ms.quality, math.inf)
    order = torch.argsort(torch.where(ms.valid, -ms.quality, inf), dim=-1,
                          stable=True)

    def take(a):
        if a.dim() == 3:
            return torch.gather(a, 1, order[..., None].expand_as(a))
        return torch.gather(a, 1, order)

    rank = torch.arange(k, device=order.device)
    new_valid = take(ms.valid) & (rank < max_minutiae)[None, :]
    q = take(ms.quality)
    return MinutiaeSet(
        xy=take(ms.xy),
        minutia_type=take(ms.minutia_type),
        orientation=take(ms.orientation),
        quality=torch.where(new_valid, q, torch.zeros_like(q)),
        coherence=take(ms.coherence),
        angular_stability=take(ms.angular_stability),
        valid=new_valid,
    )


@traced("features.postprocess")
def postprocess_minutiae(ms: MinutiaeSet, skel: torch.Tensor,
                         quality_window: int = 25,
                         quality_threshold: float = 0.15,
                         coherence_threshold: float = 0.2,
                         min_distance: float = 8.0,
                         margin: int = 30,
                         max_minutiae: int = 60,
                         patch_radius: int = 15,
                         dedup_radius: float = 20.0,
                         dedup_angle: float = math.radians(30.0)) -> MinutiaeSet:
    """Quality scoring + NMS + dedup over (..., H, W) skeletons with
    matching (..., K) minutiae sets. Defaults are the reference's.

    Spans, under ``features.postprocess``: ``features.enrich`` (the
    density map, the skeleton's orientation field and the quality
    scoring), ``features.nms``, ``features.redundant`` and
    ``features.sort_cap``."""
    lead = skel.shape[:-2]
    h, w = skel.shape[-2:]
    flat =MinutiaeSet(*(a.reshape((-1,) + a.shape[len(lead):]) for a in ms))
    sk = skel.reshape(-1, h, w).to(torch.float32)

    with span("features.enrich"):
        density = blur_mean(sk, quality_window)
        density = density / (torch.amax(density, dim=(-2, -1), keepdim=True)
                             + 1e-6)

        # orientation/coherence re-estimated on the skeleton image itself
        field = compute_orientation_field(sk)
        coherence = torch.clamp(field.reliability, 0.0, 1.0)

        flat = _enrich(flat, sk, density, field.orientation, coherence,
                       quality_threshold, coherence_threshold, margin,
                       patch_radius)
    with span("features.nms"):
        keep = _nms_adaptive(flat, density, min_distance, h, w)
    with span("features.redundant"):
        keep = _remove_redundant_oriented(flat, keep, density, dedup_radius,
                                          dedup_angle, h, w)
    with span("features.sort_cap"):
        flat = flat._replace(valid=keep, quality=torch.where(
            keep, flat.quality, torch.zeros_like(flat.quality)))
        out = _sort_and_cap(flat, max_minutiae)
    return MinutiaeSet(*(a.reshape(lead + a.shape[1:]) for a in out))
