# Frozen copy of the port's ``ops/geometry.py`` for the benchmark's reference:
# the CUDA wrappers are removed and every dispatcher calls the plain
# twin on any device. Edit only to follow a change of semantics.
"""Geometry helpers: point transforms, angle wrapping, resize and warp
(port of ``ops/geometry.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch


def rotate_points(points: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 2) xy points by theta (radians)."""
    theta = torch.as_tensor(theta, dtype=points.dtype, device=points.device)
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    return torch.einsum("...ij,...nj->...ni", rot, points)


def angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapped angular difference in [-pi, pi]."""
    d = a - b
    return torch.remainder(d + math.pi, 2.0 * math.pi) - math.pi


def orientation_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Difference of undirected ridge orientations, wrapped to [-pi/2, pi/2]."""
    d = a - b
    return torch.remainder(d + math.pi / 2.0, math.pi) - math.pi / 2.0


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis, step for step: half-pixel centres, a triangle kernel
    widened by the scale when it shrinks (the antialias), columns
    normalised to sum 1, samples outside the input zeroed."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale)
              - f32(0.0) - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]
               ) / kernel_scale
    wgt = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = wgt.sum(axis=0, keepdims=True, dtype=f32)
    wgt = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                   wgt / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wgt, f32(0.0)).astype(f32)


def resize_bilinear(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the trailing two dims (``jax.image.resize``
    "bilinear": it antialiases when it shrinks an axis, unlike
    ``F.interpolate``'s default). An axis whose size stays is left as it
    is; each other axis is one float32 product with its weight matrix."""
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    if shape[0] != h:
        wh = torch.from_numpy(_resize_weights(h, shape[0])).to(x.device)
        x = torch.matmul(wh.T, x)
    if shape[1] != w:
        ww = torch.from_numpy(_resize_weights(w, shape[1])).to(x.device)
        x = torch.matmul(x, ww)
    return x


def affine_warp(img: torch.Tensor, matrix, fill: float = 0.0) -> torch.Tensor:
    """Inverse-warp a 2-D image with a 2x3 affine matrix (cv2.warpAffine
    semantics: ``matrix`` maps src -> dst; we sample with its inverse).

    img: (H, W); matrix: (2, 3), taken in float32. Bilinear sampling,
    constant fill outside.
    """
    h, w = img.shape[-2:]
    m = torch.as_tensor(matrix, dtype=torch.float32, device=img.device)
    a, t = m[:, :2], m[:, 2]
    ainv = torch.linalg.inv(a)

    ys = torch.arange(h, dtype=torch.float32, device=img.device)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dst = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (HW, 2)
    src = (dst - t) @ ainv.T
    sx, sy = src[:, 0], src[:, 1]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0

    def sample(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        vals = img[yc, xc]
        return torch.where(inb, vals, torch.full_like(vals, fill))

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    return out.reshape(h, w)


def _bilinear_taps(n_in: int, n_out: int):
    """Two-tap bilinear weights of jax.image.resize(..., "bilinear") for one
    axis: half-pixel centres, out-of-range taps dropped and the remaining
    weights renormalised."""
    scale = np.float32(n_in) / np.float32(n_out)
    src = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale \
        - np.float32(0.5)
    i0 = np.floor(src).astype(np.int64)
    w1 = (src - i0.astype(np.float32)).astype(np.float32)
    w0 = (np.float32(1.0) - w1).astype(np.float32)
    lo_ok = i0 >= 0
    hi_ok = i0 + 1 <= n_in - 1
    total = np.where(lo_ok, w0, 0) + np.where(hi_ok, w1, 0)
    w0 = np.where(lo_ok, w0 / total, 0).astype(np.float32)
    w1 = np.where(hi_ok, w1 / total, 0).astype(np.float32)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w0, w1)


def _resize_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    if n_out < x.shape[axis]:
        raise ValueError("upsampling only: jax.image.resize antialiases "
                         "when it shrinks an axis")
    i0, i1, w0, w1 = _bilinear_taps(x.shape[axis], n_out)
    dev = x.device
    shape = [1] * x.ndim
    shape[axis] = n_out
    a = x.index_select(axis, torch.from_numpy(i0).to(dev))
    b = x.index_select(axis, torch.from_numpy(i1).to(dev))
    return (a * torch.from_numpy(w0).to(dev).reshape(shape)
            + b * torch.from_numpy(w1).to(dev).reshape(shape))


def upsample_bilinear_matmul(x: torch.Tensor,
                             shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling of the trailing two dims (jax.image.resize
    "bilinear" semantics), as two two-tap weighted sums."""
    x = x.to(torch.float32)
    y = _resize_axis(x, shape[0], x.ndim - 2)
    return _resize_axis(y, shape[1], x.ndim - 1)
