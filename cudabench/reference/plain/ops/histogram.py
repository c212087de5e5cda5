# Frozen copy of the port's ``ops/histogram.py`` for the benchmark's reference:
# the CUDA wrappers are removed and every dispatcher calls the plain
# twin on any device. Edit only to follow a change of semantics.
"""Histogram ops: percentile stretch, Otsu thresholding, CLAHE, global
equalization (port of ``ops/histogram.py``).

Histograms are scatter-adds (``scatter_add_``), which are cheap on a GPU;
quantiles are the same value-axis bisection as the JAX package. CLAHE
dispatches to the hand-written CUDA kernel for CUDA tensors
(``ops.cuda_kernels.clahe``). Images are float32 in [0, 1] throughout.
"""

from __future__ import annotations

import torch

from .cuda_kernels import bin_to_unit, clahe as _clahe_dispatch

NBINS = 256


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """[0,1] float -> integer bin index 0..255 (round half to even)."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.int32)


def histogram256(values: torch.Tensor,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row 256-bin histogram. values: (..., N) int in [0, 255].
    Returns (..., 256) float32 counts (weighted by ``weights`` if given)."""
    lead = values.shape[:-1]
    n = values.shape[-1]
    v = values.reshape(-1, n).to(torch.int64)
    if weights is None:
        src = torch.ones(v.shape, dtype=torch.float32, device=v.device)
    else:
        src = weights.reshape(-1, n).to(torch.float32)
    hist = torch.zeros((v.shape[0], NBINS), dtype=torch.float32,
                       device=v.device)
    hist.scatter_add_(1, v, src)
    return hist.reshape(lead + (NBINS,))


def quantiles_bisect(x: torch.Tensor, qs, iters: int = 24,
                     snap_u8: bool = False) -> torch.Tensor:
    """np.percentile('linear') over the trailing two dims by bisection on
    the value axis: ``iters`` count(x <= mid) passes per order statistic.
    Returns (..., len(qs))."""
    lead = x.shape[:-2]
    n = x.shape[-2] * x.shape[-1]
    xb = x.reshape(lead + (1, n))
    qs = torch.atleast_1d(torch.as_tensor(qs, dtype=torch.float32,
                                          device=x.device))
    nq = qs.shape[0]
    # virtual order stats; a tensor divisor, so a true division on every
    # device (see cuda_kernels.bin_to_unit)
    v = (n - 1) * qs / torch.full((), 100.0, device=x.device)
    k0 = torch.floor(v)
    ks = torch.cat([k0, torch.ceil(v)])           # (2Q,)
    thresh = ks + 1.0                             # count needed to cover k-th

    xmin = torch.amin(xb, dim=-1)                 # (..., 1)
    xmax = torch.amax(xb, dim=-1)
    span = xmax - xmin
    lo = (xmin - span * 1e-3 - 1e-12).expand(lead + (2 * nq,))
    hi = xmax.expand(lead + (2 * nq,))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = torch.sum((xb <= mid[..., None]).to(torch.float32), dim=-1)
        covered = cnt >= thresh                   # k-th order stat <= mid
        lo, hi = torch.where(covered, lo, mid), torch.where(covered, mid, hi)
    if snap_u8:
        # order statistics sit on the 1/255 grid; rounding recovers them
        hi = bin_to_unit(torch.round(hi * 255.0))
    lo_stat = hi[..., :nq]
    hi_stat = hi[..., nq:]
    return lo_stat + (v - k0) * (hi_stat - lo_stat)


def quantiles_u8(x: torch.Tensor, qs) -> torch.Tensor:
    """Exact np.percentile over trailing two dims for u8-grid data in [0,1].
    Returns (..., len(qs)) in [0,1]."""
    xq = bin_to_unit(_to_u8(x).to(torch.float32))
    return quantiles_bisect(xq, qs, iters=16, snap_u8=True)


def quantiles_approx(x: torch.Tensor, qs, bins: int = 1024) -> torch.Tensor:
    """Quantiles over trailing two dims for continuous data, by bisection
    (error range * 2^-24). ``bins`` is accepted for signature parity."""
    del bins
    return quantiles_bisect(x, qs, iters=24)


def percentile_stretch(x: torch.Tensor, p_low: float = 0.5,
                       p_high: float = 99.5,
                       axes: tuple[int, ...] = (-2, -1)) -> torch.Tensor:
    """Percentile contrast stretch to [0,1] on the u8 grid."""
    xq = bin_to_unit(_to_u8(x).to(torch.float32))
    q = quantiles_u8(xq, [p_low, p_high])
    lo = q[..., 0][..., None, None]
    hi = q[..., 1][..., None, None]
    return torch.clamp((xq - lo) / torch.clamp(hi - lo, min=1e-8), 0.0, 1.0)


def _otsu_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """Otsu threshold (bin index, float) from (..., 256) histograms;
    foreground = pixels with value > threshold (skimage convention)."""
    p = hist / torch.clamp(torch.sum(hist, dim=-1, keepdim=True), min=1e-8)
    bins = torch.arange(NBINS, dtype=torch.float32, device=hist.device)
    omega = torch.cumsum(p, dim=-1)
    mu = torch.cumsum(p * bins, dim=-1)
    mu_t = mu[..., -1:]
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(
        denom > 1e-8,
        (mu_t * omega - mu) ** 2 / torch.clamp(denom, min=1e-8),
        torch.zeros((), dtype=torch.float32, device=hist.device))
    # torch.argmax returns the first maximal index, like jnp.argmax
    return torch.argmax(sigma_b, dim=-1).to(torch.float32)


def otsu_threshold(x: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Global Otsu threshold in [0,1] over the trailing two dims."""
    lead = x.shape[:-2]
    v = _to_u8(x).reshape(lead + (-1,))
    w = None if mask is None else mask.reshape(lead + (-1,))
    return bin_to_unit(_otsu_from_hist(histogram256(v, w)))


def otsu_threshold_patchwise(x: torch.Tensor, patch: int,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-patch Otsu thresholds over a (patch x patch) grid; returns
    per-pixel thresholds (..., H, W), constant within each patch."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    gh, gw = h // patch, w // patch

    def tiles(a):
        a = a.reshape(lead + (gh, patch, gw, patch))
        return a.transpose(-3, -2).reshape(lead + (gh, gw, patch * patch))

    wts = None if mask is None else tiles(mask)
    thr = bin_to_unit(_otsu_from_hist(histogram256(tiles(_to_u8(x)), wts)))
    return thr.repeat_interleave(patch, dim=-1).repeat_interleave(patch, dim=-2)


def clahe(x: torch.Tensor, clip_limit: float = 2.5, grid: int = 8) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization
    (cv2.createCLAHE(clipLimit, (grid, grid)) semantics): per-tile 256-bin
    histogram, integer clip limit with even excess redistribution, CDF LUT,
    bilinear blend of the four neighbouring tile LUTs.

    x: (..., H, W) float32 in [0,1], H and W divisible by ``grid``. CUDA
    tensors run kernel A (``csrc/clahe.cu``); CPU tensors its plain twin.
    """
    return _clahe_dispatch(x, clip_limit, grid)


def equalize_hist(x: torch.Tensor) -> torch.Tensor:
    """Global histogram equalization over the trailing two dims."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    v = _to_u8(x).reshape(lead + (-1,)).to(torch.int64)
    cdf = torch.cumsum(histogram256(v), dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1.0)
    return torch.gather(cdf, -1, v).reshape(lead + (h, w))
