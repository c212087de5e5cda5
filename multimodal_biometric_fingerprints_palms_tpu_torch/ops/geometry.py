"""Geometry helpers (port of the part of ``ops/geometry.py`` the slice uses)."""

from __future__ import annotations

import numpy as np
import torch


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
