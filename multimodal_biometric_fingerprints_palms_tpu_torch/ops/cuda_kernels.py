"""CLAHE: kernel A (``csrc/clahe.cu``) and its plain PyTorch twin.

Replaces the TPU kernel ``ops/pallas_kernels.py:clahe_pallas``
(``_clahe_kernel_v2`` / ``_clahe_kernel``), which built per-tile histograms
and applied the LUTs as one-hot MXU matmuls. On the card the work is tiny
(a 256-entry table per tile, four table reads and a blend per pixel), so
the kernel is bound by memory traffic. Two device launches a call: pass 1
builds each tile's histogram in per-warp sub-histograms and turns it into a
byte LUT with one thread a bin (the excess and the CDF are sums that are
exact in float32 in any order up to a tile area of 65,536, so the LUT is
bit-equal to the plain version's; larger tiles keep its serial order);
pass 2 stages the 3 x 3 neighbouring LUTs and the tile's row table in
shared memory and blends per pixel with explicitly rounded float ops (no
FMA contraction), matching the plain version's arithmetic.

``clahe`` dispatches on the tensor's device: CPU -> ``clahe_plain``,
CUDA -> ``clahe_cuda``; anything else raises.
"""

from __future__ import annotations

import torch

from ..kernels import build as _build
from ..utils.profiling import count

NBINS = 256
_MAX_TILE_ROWS = 2560    # pass 2 keeps 16 bytes a tile row in shared memory


def _clip_limit(clip_limit: float, tile_area: int) -> float:
    # OpenCV truncates the clip limit to an integer (clahe.cpp)
    return max(float(int(clip_limit * tile_area / NBINS)), 1.0)


def _blend_weights(n: int, tile: int, grid: int, device):
    """Per-coordinate (lo tile, hi tile, weight of hi tile), OpenCV's
    convention: tile coordinate = pixel / tile_size - 0.5."""
    # a tensor divisor: a true division on every device (see bin_to_unit)
    c = torch.arange(n, dtype=torch.float32, device=device) / torch.full(
        (), float(tile), device=device) - 0.5
    fl = torch.floor(c)
    w1 = torch.clamp(c - fl, 0.0, 1.0)
    w1 = torch.where(c < 0, torch.zeros_like(w1),
                     torch.where(c > grid - 1, torch.ones_like(w1), w1))
    t0 = torch.clamp(fl, 0, grid - 1).to(torch.int64)
    t1 = torch.clamp(fl + 1, 0, grid - 1).to(torch.int64)
    return t0, t1, w1


def bin_to_unit(idx: torch.Tensor) -> torch.Tensor:
    """Bin index -> [0,1] by a true float32 division on every device. The
    divisor is a tensor because PyTorch on CUDA turns a division by a Python
    scalar into a multiplication by its reciprocal, which lands one ulp off
    ``bin / 255`` for some bins and flips ``x < thr`` for every pixel that
    sits exactly on the threshold's grid value. Kernel A divides truly."""
    return idx / torch.full((), 255.0, dtype=idx.dtype, device=idx.device)


def _to_bins(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.int64)


def clahe_lut_plain(x: torch.Tensor, clip_limit: float = 2.5,
                    grid: int = 8) -> torch.Tensor:
    """Per-tile CLAHE LUTs of (..., H, W) images: (..., grid, grid, 256)
    float32 integer values in [0, 255]."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    th, tw = h // grid, w // grid
    area = th * tw
    v = _to_bins(x.reshape(-1, h, w))
    tiles = v.reshape(-1, grid, th, grid, tw).transpose(2, 3).reshape(-1, area)
    hist = torch.zeros((tiles.shape[0], NBINS), dtype=torch.float32,
                       device=x.device)
    hist.scatter_add_(1, tiles, torch.ones(tiles.shape, dtype=torch.float32,
                                           device=x.device))
    limit = _clip_limit(clip_limit, area)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / NBINS
    cdf = torch.cumsum(hist, dim=-1)
    lut = torch.clamp(torch.round(cdf * ((NBINS - 1.0) / area)), 0, 255)
    return lut.reshape(lead + (grid, grid, NBINS))


def _butterfly_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (a power of two) as a warp butterfly takes it:
    element i adds element i ^ off for off = n/2 .. 1."""
    n = v.shape[-1]
    idx = torch.arange(n, device=v.device)
    off = n // 2
    while off:
        v = v + v[..., idx ^ off]
        off //= 2
    return v[..., 0]


def clahe_lut_scan_plain(x: torch.Tensor, clip_limit: float = 2.5,
                         grid: int = 8) -> torch.Tensor:
    """``clahe_lut_plain`` with its two sums taken in the order of kernel
    A's pass 1 (a thread a bin, 8 warps): the excess as a butterfly over
    each warp's 32 bins and then over the warps in turn, the CDF as a
    Hillis-Steele scan inside each warp plus the sum of the warps before
    it; returned as the kernel stores it, uint8. No path uses it; the tests
    hold it to ``clahe_lut_plain`` (the sums are exact in float32 in any
    order while a tile holds at most 65,536 pixels)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    th, tw = h // grid, w // grid
    area = th * tw
    v = _to_bins(x.reshape(-1, h, w))
    tiles = v.reshape(-1, grid, th, grid, tw).transpose(2, 3).reshape(-1, area)
    hist = torch.zeros((tiles.shape[0], NBINS), dtype=torch.float32,
                       device=x.device)
    hist.scatter_add_(1, tiles, torch.ones(tiles.shape, dtype=torch.float32,
                                           device=x.device))
    limit = _clip_limit(clip_limit, area)
    warps = torch.clamp(hist - limit, min=0.0).reshape(-1, 8, 32)
    partial = _butterfly_sum(warps)
    excess = torch.zeros_like(partial[:, 0])
    for k in range(8):
        excess = excess + partial[:, k]
    cdf = (torch.clamp(hist, max=limit)
           + (excess / NBINS)[:, None]).reshape(-1, 8, 32)
    lane = torch.arange(32, device=x.device)
    off = 1
    while off < 32:
        up = cdf[..., torch.clamp(lane - off, min=0)]
        cdf = torch.where(lane >= off, cdf + up, cdf)
        off *= 2
    before = torch.zeros_like(cdf[:, 0, 0])
    for k in range(8):
        total = cdf[:, k, 31].clone()
        cdf[:, k] = before[:, None] + cdf[:, k]
        before = before + total
    lut = torch.clamp(torch.round(cdf.reshape(-1, NBINS)
                                  * ((NBINS - 1.0) / area)), 0, 255)
    return lut.to(torch.uint8).reshape(lead + (grid, grid, NBINS))


def clahe_plain(x: torch.Tensor, clip_limit: float = 2.5,
                grid: int = 8) -> torch.Tensor:
    """Plain PyTorch CLAHE over (..., H, W) float32 in [0, 1]."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    th, tw = h // grid, w // grid
    flat = x.reshape(-1, h, w)
    b = flat.shape[0]
    v = _to_bins(flat)
    lut = clahe_lut_plain(flat, clip_limit, grid).reshape(b, -1)

    y0, y1, wy1 = _blend_weights(h, th, grid, x.device)
    x0, x1, wx1 = _blend_weights(w, tw, grid, x.device)
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    def tap(ty, tx):
        idx = (ty[:, None] * grid + tx[None, :]) * NBINS + v    # (b, h, w)
        return torch.gather(lut, 1, idx.reshape(b, -1)).reshape(b, h, w)

    out = tap(y0, x0) * (wy0[:, None] * wx0[None, :])
    out = out + tap(y0, x1) * (wy0[:, None] * wx1[None, :])
    out = out + tap(y1, x0) * (wy1[:, None] * wx0[None, :])
    out = out + tap(y1, x1) * (wy1[:, None] * wx1[None, :])
    return torch.clamp(bin_to_unit(out), 0.0, 1.0).reshape(lead + (h, w))


def clahe_cuda(x: torch.Tensor, clip_limit: float = 2.5, grid: int = 8,
               return_lut: bool = False):
    """Kernel A on a CUDA tensor; same contract as ``clahe_plain``. With
    ``return_lut`` also the tiles' LUTs as pass 1 left them,
    (..., grid, grid, 256) uint8 (``clahe_lut_plain``'s values)."""
    if x.device.type != "cuda":
        raise ValueError(f"clahe_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"clahe_cuda needs float32, got {x.dtype}")
    h, w = x.shape[-2:]
    if h % grid or w % grid:
        raise ValueError(f"H, W ({h}, {w}) must be divisible by grid {grid}")
    lead = x.shape[:-2]
    flat = x.reshape(-1, h, w).contiguous()
    b = flat.shape[0]
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside 1..65535")
    if h * w >= 2 ** 31 or h // grid > _MAX_TILE_ROWS:
        raise ValueError(f"frame ({h}, {w}) too large for kernel A")
    area = (h // grid) * (w // grid)
    lut = torch.empty((b, grid, grid, NBINS), dtype=torch.uint8,
                      device=x.device)
    out = torch.empty_like(flat)
    lib = _build.load_library()
    rc = lib.mbfp_clahe(flat.data_ptr(), lut.data_ptr(), out.data_ptr(),
                        b, h, w, grid, _clip_limit(clip_limit, area),
                        (NBINS - 1.0) / area, _build.current_stream(x))
    _build.check(rc, "mbfp_clahe")
    count("kernel.clahe")
    out = out.reshape(lead + (h, w))
    if return_lut:
        return out, lut.reshape(lead + (grid, grid, NBINS))
    return out


def clahe(x: torch.Tensor, clip_limit: float = 2.5, grid: int = 8) -> torch.Tensor:
    if x.device.type == "cpu":
        return clahe_plain(x, clip_limit, grid)
    return clahe_cuda(x, clip_limit, grid)
