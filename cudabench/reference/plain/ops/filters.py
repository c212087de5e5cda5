# Frozen copy of the port's ``ops/filters.py`` for the benchmark's reference:
# the CUDA wrappers are removed and every dispatcher calls the plain
# twin on any device. Edit only to follow a change of semantics.
"""Separable / small-stencil filters (port of ``ops/filters.py``).

All functions take (..., H, W) float32 tensors and operate on the trailing
two dims. Every 1-D pass is a sum of shifted, weighted copies in tap order,
the same arithmetic as the JAX package's small-kernel path; no cuDNN
convolution is involved, so no TF32 rounding can enter.

Border rules (``_border_index``): "reflect" is numpy's "symmetric"
(-1 -> 0, n -> n-1), "mirror" is numpy's "reflect" / OpenCV's
BORDER_REFLECT_101, "edge" repeats the edge, "zero" contributes nothing.
"""

from __future__ import annotations

import numpy as np
import torch


def _border_index(j: int, n: int, border: str) -> int | None:
    """Map an out-of-range tap index into [0, n) under the border rule;
    None = tap contributes nothing ("zero" border)."""
    while j < 0 or j >= n:
        if border == "zero":
            return None
        if border == "edge":
            return min(max(j, 0), n - 1)
        if border == "reflect":      # numpy "symmetric": -1 -> 0, n -> n-1
            j = -1 - j if j < 0 else 2 * n - 1 - j
        elif border == "mirror":     # numpy "reflect" / REFLECT_101
            j = -j if j < 0 else 2 * n - 2 - j
        else:
            raise ValueError(border)
    return j


def _pad_axis(x: torch.Tensor, axis: int, before: int, after: int,
              border: str) -> torch.Tensor:
    """Pad ``x`` along ``axis`` under the border rule."""
    n = x.shape[axis]
    if border == "zero":
        shape = list(x.shape)
        parts = []
        if before:
            shape[axis] = before
            parts.append(x.new_zeros(shape))
        parts.append(x)
        if after:
            shape[axis] = after
            parts.append(x.new_zeros(shape))
        return torch.cat(parts, dim=axis)
    idx = [_border_index(i - before, n, border)
           for i in range(n + before + after)]
    return x.index_select(axis, torch.tensor(idx, device=x.device))


def _conv1d_axis(x: torch.Tensor, taps, axis: int, border: str) -> torch.Tensor:
    """1-D correlation along ``axis`` (-1 or -2) of (..., H, W)."""
    taps = np.asarray(taps, np.float32).reshape(-1)
    k = taps.shape[0]
    ax = axis % x.ndim
    n = x.shape[ax]
    c = k // 2
    padded = _pad_axis(x, ax, c, k - 1 - c, border)
    out = None
    for t in range(k):
        wgt = float(taps[t])
        if wgt == 0.0:
            continue
        piece = wgt * padded.narrow(ax, t, n)
        out = piece if out is None else out + piece
    return out if out is not None else torch.zeros_like(x)


def conv2d_same(x: torch.Tensor, kernel, border: str = "reflect") -> torch.Tensor:
    """2-D correlation with SAME-size output on the trailing dims.

    kernel: (kh, kw) array. border: "reflect" (default), "edge", "mirror"
    or "zero".
    """
    kern = np.asarray(kernel, dtype=np.float32)
    kh, kw = kern.shape
    x = x.to(torch.float32)
    if 1 in (kh, kw):
        return _conv1d_axis(x, kern.reshape(-1), -1 if kh == 1 else -2, border)
    ph, pw = kh // 2, kw // 2
    padded = _pad_axis(x, x.ndim - 2, ph, kh - 1 - ph, border)
    padded = _pad_axis(padded, x.ndim - 1, pw, kw - 1 - pw, border)
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    for dy in range(kh):
        for dx in range(kw):
            wgt = float(kern[dy, dx])
            if wgt == 0.0:
                continue
            out = out + wgt * padded[..., dy:dy + h, dx:dx + w]
    return out


def _separable(x: torch.Tensor, k1d, border: str) -> torch.Tensor:
    x = _conv1d_axis(x, k1d, -2, border)
    return _conv1d_axis(x, k1d, -1, border)


def gaussian_kernel1d(sigma: float, radius: int | None = None,
                      truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage-compatible 1-D Gaussian (truncate=4.0 default)."""
    if radius is None:
        radius = int(truncate * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    return (k / np.sum(k)).astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float, radius: int | None = None,
                  truncate: float = 4.0, border: str = "reflect") -> torch.Tensor:
    """Separable Gaussian blur (scipy.ndimage.gaussian_filter semantics)."""
    if sigma <= 0:
        return x
    return _separable(x, gaussian_kernel1d(sigma, radius=radius,
                                           truncate=truncate), border)


def box_filter(x: torch.Tensor, size: int, border: str = "reflect") -> torch.Tensor:
    """Mean filter (cv2.boxFilter / blur semantics)."""
    return _separable(x, np.full((size,), 1.0 / size, dtype=np.float32), border)


def blur_mean(x: torch.Tensor, size: int) -> torch.Tensor:
    """Alias matching cv2.blur semantics."""
    return box_filter(x, size)


_SOBEL_X = np.array([[-1.0, 0.0, 1.0],
                     [-2.0, 0.0, 2.0],
                     [-1.0, 0.0, 1.0]], dtype=np.float32)


def sobel(x: torch.Tensor, border: str = "reflect"
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gradients (gx, gy)."""
    return (conv2d_same(x, _SOBEL_X, border=border),
            conv2d_same(x, _SOBEL_X.T, border=border))


def gaussian_blur_cv(x: torch.Tensor, ksize: int, sigma: float,
                     border: str = "reflect") -> torch.Tensor:
    """OpenCV-style Gaussian with explicit odd kernel size
    (cv2.GaussianBlur(img, (k, k), sigma))."""
    if sigma <= 0:  # OpenCV derives sigma from ksize when sigma == 0
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    return _separable(x, gaussian_kernel1d(sigma, radius=ksize // 2), border)
