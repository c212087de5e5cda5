# Frozen copy of the port's ``ops/orientation.py`` for the benchmark's reference:
# the CUDA wrappers are removed and every dispatcher calls the plain
# twin on any device. Edit only to follow a change of semantics.
"""Ridge orientation field (port of ``ops/orientation.py``): the gradient
structure-tensor method with per-block reliability-weighted circular means.

Semantics as in the JAX package: polarity auto-invert around the median,
pre-smooth sigma max(0.5, smooth_sigma / 2), Sobel with the mirror border,
structure tensor products rounded to bfloat16 before smoothing, reliability
clipped at the [2, 98] percentiles, blocks below the 0.3 mask-coverage gate
left at 0, block field smoothed in the doubled-angle domain, then bilinear
upsampling and a wrap to [-pi/2, pi/2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .filters import gaussian_blur, sobel
from .geometry import upsample_bilinear_matmul
from .histogram import quantiles_approx, quantiles_u8


class OrientationField(NamedTuple):
    block_orientation: torch.Tensor   # (..., H/bs, W/bs)
    block_valid: torch.Tensor         # (..., H/bs, W/bs) bool
    orientation: torch.Tensor         # (..., H, W), [-pi/2, pi/2)
    reliability: torch.Tensor         # (..., H, W) in [0,1] (block-mean, upsampled)
    pixel_reliability: torch.Tensor   # (..., H, W) raw per-pixel reliability


def _block_reduce_sum(x: torch.Tensor, bs: int) -> torch.Tensor:
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    return x.reshape(lead + (h // bs, bs, w // bs, bs)).sum(dim=(-3, -1))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def compute_orientation_field(
    img: torch.Tensor,
    mask: torch.Tensor | None = None,
    block_size: int = 16,
    smooth_sigma: float = 3.0,
    smooth_orientation_sigma: float = 3.0,
    coverage_gate: float = 0.3,
    reliability_clip: tuple[float, float] = (2.0, 98.0),
    invert_if_needed: bool = True,
) -> OrientationField:
    """Structure-tensor orientation field over (..., H, W) in [0,1]; H and W
    must be divisible by ``block_size``."""
    f = img.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=f.device)

    if invert_if_needed:
        med = quantiles_u8(f, [50.0])[..., 0][..., None, None]
        up = f > med
        above = torch.where(up, f, zero).sum(dim=(-2, -1), keepdim=True)
        n_above = up.to(torch.float32).sum(dim=(-2, -1), keepdim=True)
        below = torch.where(~up, f, zero).sum(dim=(-2, -1), keepdim=True)
        n_below = (~up).to(torch.float32).sum(dim=(-2, -1), keepdim=True)
        invert = ((above / torch.clamp(n_above, min=1.0))
                  > (below / torch.clamp(n_below, min=1.0)))
        f = torch.where(invert, 1.0 - f, f)

    f_s = gaussian_blur(f, max(0.5, smooth_sigma / 2.0))
    gx, gy = sobel(f_s, border="mirror")  # cv2.Sobel uses BORDER_REFLECT_101
    gxb, gyb = _bf16(gx), _bf16(gy)
    gxx = gaussian_blur(_bf16(gxb * gxb), smooth_sigma)
    gyy = gaussian_blur(_bf16(gyb * gyb), smooth_sigma)
    gxy = gaussian_blur(_bf16(gxb * gyb), smooth_sigma)

    r = torch.sqrt((gxx - gyy) ** 2 + 4.0 * gxy * gxy)
    q = quantiles_approx(r, list(reliability_clip), bins=2048)
    lo = q[..., 0][..., None, None]
    hi = q[..., 1][..., None, None]
    rel = torch.clamp((r - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)

    # sin/cos of the doubled pixel angle straight from the tensor (the
    # reference's atan2 + pi/2 shifts 2*theta by pi)
    bs = block_size
    r_safe = torch.clamp(r, min=1e-12)
    sin2t = -2.0 * gxy / r_safe
    cos2t = -((gxx - gyy) + 1e-12) / r_safe
    w = rel + 1e-6
    s_sum = _block_reduce_sum(w * sin2t, bs)
    c_sum = _block_reduce_sum(w * cos2t, bs)
    rel_mean = _block_reduce_sum(rel, bs) / float(bs * bs)

    if mask is not None:
        coverage = _block_reduce_sum(mask.to(torch.float32), bs) / float(bs * bs)
        block_valid = coverage >= coverage_gate
    else:
        block_valid = torch.ones(s_sum.shape, dtype=torch.bool, device=f.device)

    block_theta = torch.where(block_valid, 0.5 * torch.atan2(s_sum, c_sum), zero)
    rel_blocks = torch.where(block_valid, rel_mean, zero)

    if smooth_orientation_sigma > 0:
        sin2 = gaussian_blur(torch.sin(2.0 * block_theta), smooth_orientation_sigma)
        cos2 = gaussian_blur(torch.cos(2.0 * block_theta), smooth_orientation_sigma)
        block_theta = 0.5 * torch.atan2(sin2, cos2)

    h, w_ = f.shape[-2:]
    orient = upsample_bilinear_matmul(block_theta, (h, w_))
    orient = torch.remainder(orient + math.pi / 2.0, math.pi) - math.pi / 2.0
    rel_img = upsample_bilinear_matmul(rel_blocks, (h, w_))
    return OrientationField(block_theta, block_valid, orient, rel_img, rel)
