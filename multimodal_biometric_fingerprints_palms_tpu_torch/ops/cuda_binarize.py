"""The binarize stage after CLAHE: kernel F (``csrc/binarize.cu``), its
plain twin, and the compositions with kernels B and G.

Kernel F replaces the front of the TPU kernels
``ops/pallas_kernels.py:binarize_fused_split_pallas`` (``_binarize_fg_kernel``)
and ``binarize_fused_pallas``, and ``sauvola_binarize_pallas``: adaptive
Sauvola (window 25, k-map ``k * (1 - 0.5 * std_n)``) OR-ed with a
per-32x32-patch Otsu threshold gated by the patch std (>= 3/255). Two
device launches a call: box mean and std of every pixel, once, into scratch
with each image's max(std); then the threshold, with the Otsu half of a
patch on four warps. Both in the twin's operation order; bound by the
instruction rate (see the source).

The rest of the TPU split is composition here. Its phase 2
(``_binarize_phase2_kernel``) filled holes below ``max_size`` with two
canonical background components decided by popcount on packed planes, so
that the TPU would not relax the valley network per image; kernel B's
union-find has no such cost, so ``fill_holes_phase2`` is B's "fill_holes"
mode and gives the same mask (``ops/cuda_cc.py`` argues the same for the
object filter). The tail is kernel G (``ops/cuda_morph.py``).

``binarize_foreground`` and ``sauvola_binarize`` dispatch on the device: CPU
tensors run the plain twins, CUDA tensors launch kernel F; anything else
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build as _build
from ..utils.profiling import count
from .cuda_cc import cc_filter
from .cuda_morph import open_erode_reconstruct
from .filters import box_filter
from .histogram import otsu_threshold_patchwise

_MAX_WIN = 33            # kernel F's largest Sauvola window
_TILE = 32               # kernel F's tile, and the Otsu patch it supports


def sauvola_plain(img_eq: torch.Tensor, win: int = 25,
                  k: float = 0.25) -> torch.Tensor:
    """Adaptive Sauvola over (..., H, W) float32 in [0,1] -> bool."""
    mean = box_filter(img_eq, win)
    sqmean = box_filter(img_eq * img_eq, win)
    std = torch.sqrt(torch.clamp(sqmean - mean * mean, min=0.0))
    std_n = std / (torch.amax(std, dim=(-2, -1), keepdim=True) + 1e-6)
    k_map = k * (1.0 - 0.5 * std_n)
    sauv = mean * (1.0 - k_map * (1.0 - std / (mean + 1e-6)))
    return img_eq < sauv


def binarize_foreground_plain(img_eq: torch.Tensor, win: int = 25,
                              k: float = 0.25,
                              patch: int = 32) -> torch.Tensor:
    """Plain PyTorch twin of kernel F: Sauvola OR the gated per-patch Otsu
    refinement, over (..., H, W) float32 in [0,1] with H, W multiples of
    ``patch`` -> bool."""
    binary = sauvola_plain(img_eq, win, k)
    thr = otsu_threshold_patchwise(img_eq, patch)
    lead = img_eq.shape[:-2]
    h, w = img_eq.shape[-2:]
    blocks = img_eq.reshape(lead + (h // patch, patch, w // patch, patch))
    centred = blocks - blocks.mean(dim=(-3, -1), keepdim=True)
    p_std = torch.sqrt((centred * centred).mean(dim=(-3, -1)))
    p_std = p_std.repeat_interleave(patch, dim=-1).repeat_interleave(patch, dim=-2)
    return binary | ((img_eq < thr) & (p_std >= 3.0 / 255.0))


def box_mean_std_passes_plain(img: torch.Tensor, win: int = 25):
    """Box mean and std of (..., H, W) as kernel F's launch 1 takes them:
    ``fl(tap * a)`` and ``fl(tap * fl(a * a))`` formed once per element, the
    vertical sums added in tap order, ``fl(tap * v)`` formed once per
    vertical sum, the horizontal sums added in tap order. No path uses it;
    the tests hold it to ``box_filter`` bit for bit."""
    from .filters import _pad_axis
    tap = float(np.float32(1.0 / win))
    c = win // 2

    def sums(plane, axis):
        n = plane.shape[axis]
        padded = _pad_axis(plane, plane.ndim + axis, c, win - 1 - c, "reflect")
        out = padded.narrow(axis, 0, n)
        for t in range(1, win):
            out = out + padded.narrow(axis, t, n)
        return out

    mean = sums(tap * sums(tap * img, -2), -1)
    sqmean = sums(tap * sums(tap * (img * img), -2), -1)
    return mean, torch.sqrt(torch.clamp(sqmean - mean * mean, min=0.0))


def otsu_patch_passes_plain(img_eq: torch.Tensor, patch: int = 32):
    """Per-patch Otsu bin and patch std of (..., H, W) as kernel F's launch
    2 takes them: omega and mu as eight bins a lane plus a scan over the
    lanes, the patch mean and variance as a butterfly over the columns of
    each row and then over the rows. Returns (bin, std), each
    (..., H/patch, W/patch). No path uses it; the tests hold it to
    ``otsu_threshold_patchwise`` and to the twin's patch std."""
    from .cuda_kernels import _butterfly_sum, _to_bins
    lead = img_eq.shape[:-2]
    h, w = img_eq.shape[-2:]
    gh, gw = h // patch, w // patch
    blocks = img_eq.reshape(lead + (gh, patch, gw, patch)).transpose(-3, -2)
    area = float(patch * patch)
    hist = torch.zeros(lead + (gh, gw, 256), dtype=torch.float32,
                       device=img_eq.device)
    hist.scatter_add_(-1, _to_bins(blocks).flatten(-2),
                      torch.ones(lead + (gh, gw, patch * patch),
                                 device=img_eq.device))
    p = (hist / area).reshape(lead + (gh, gw, 32, 8))
    bins = torch.arange(256, dtype=torch.float32,
                        device=img_eq.device).reshape(32, 8)

    def scan(terms):
        local = torch.cumsum(terms, dim=-1)           # a lane's eight bins
        total = torch.cumsum(local[..., -1], dim=-1)  # over the lanes
        before = torch.cat([torch.zeros_like(total[..., :1]),
                            total[..., :-1]], dim=-1)
        return (before[..., None] + local).flatten(-2)

    omega, mu = scan(p), scan(p * bins)
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 1e-8, (mu[..., -1:] * omega - mu) ** 2
                          / torch.clamp(denom, min=1e-8),
                          torch.zeros((), device=img_eq.device))
    arg = torch.argmax(sigma_b, dim=-1).to(torch.float32)
    mean = _butterfly_sum(_butterfly_sum(blocks)) / area
    centred = blocks - mean[..., None, None]
    var = _butterfly_sum(_butterfly_sum(centred * centred)) / area
    return arg, torch.sqrt(var)


def _front_cuda(img_eq: torch.Tensor, win: int, k: float, otsu: bool,
                name: str) -> torch.Tensor:
    if img_eq.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {img_eq.device}")
    if img_eq.dtype != torch.float32:
        raise TypeError(f"{name} needs float32, got {img_eq.dtype}")
    if img_eq.dim() < 2:
        raise ValueError(f"need (..., H, W), got {tuple(img_eq.shape)}")
    if win % 2 == 0 or not 0 < win <= _MAX_WIN:
        raise ValueError(f"win must be odd and at most {_MAX_WIN}, got {win}")
    h, w = img_eq.shape[-2:]
    if otsu and (h % _TILE or w % _TILE):
        raise ValueError(f"H, W ({h}, {w}) must be multiples of {_TILE}")
    flat = img_eq.reshape(-1, h, w).contiguous()
    b = flat.shape[0]
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside 1..65535")
    if h * w >= 2 ** 31 or -(-h // _TILE) > 65535:
        raise ValueError(f"frame ({h}, {w}) too large for kernel F")
    stdmax = torch.zeros((b,), dtype=torch.int32, device=flat.device)
    mean_std = torch.empty((2, b, h, w), dtype=torch.float32,
                           device=flat.device)
    out = torch.empty((b, h, w), dtype=torch.bool, device=flat.device)
    rc = _build.load_library().mbfp_binarize_front(
        flat.data_ptr(), mean_std[0].data_ptr(), mean_std[1].data_ptr(),
        stdmax.data_ptr(), out.data_ptr(), b, h, w, int(win),
        float(np.float32(1.0 / win)), float(k), int(otsu),
        _build.current_stream(flat))
    _build.check(rc, "mbfp_binarize_front")
    count("kernel.binarize")
    return out.reshape(img_eq.shape)


def binarize_foreground_cuda(img_eq: torch.Tensor, win: int = 25,
                             k: float = 0.25, patch: int = 32) -> torch.Tensor:
    """Kernel F on a CUDA tensor; same contract as the plain twin."""
    if patch != _TILE:
        raise ValueError(f"kernel F supports patch {_TILE} only, got {patch}")
    return _front_cuda(img_eq, win, k, True, "binarize_foreground_cuda")


def sauvola_cuda(img_eq: torch.Tensor, win: int = 25,
                 k: float = 0.25) -> torch.Tensor:
    """Kernel F without its Otsu half on a CUDA tensor (any H, W) -> bool."""
    return _front_cuda(img_eq, win, k, False, "sauvola_cuda")


def binarize_foreground(img_eq: torch.Tensor, win: int = 25, k: float = 0.25,
                        patch: int = 32) -> torch.Tensor:
    """Sauvola OR gated per-patch Otsu over (..., H, W) float32 -> bool."""
    if img_eq.device.type == "cpu":
        return binarize_foreground_plain(img_eq, win, k, patch)
    return binarize_foreground_cuda(img_eq, win, k, patch)


def sauvola_binarize(img: torch.Tensor, win: int = 25,
                     k: float = 0.25) -> torch.Tensor:
    """(B, H, W) [0,1] -> (B, H, W) float32 {0,1} adaptive-Sauvola binary."""
    if img.device.type == "cpu":
        return sauvola_plain(img, win, k).to(torch.float32)
    return sauvola_cuda(img, win, k).to(torch.float32)


def fill_holes_phase2(kept: torch.Tensor, max_size: int = 150) -> torch.Tensor:
    """Fill the 4-connected background components of the object-filtered
    mask that are smaller than ``max_size`` (the TPU split's phase 2):
    kernel B's "fill_holes" mode."""
    return cc_filter(kept, "fill_holes", 1, max_size=max_size)


def binarize_fused_split(img_eq: torch.Tensor, win: int = 25, k: float = 0.25,
                         patch: int = 32, min_size: int = 80,
                         max_size: int = 150,
                         cc_iters: int = 512) -> torch.Tensor:
    """The binarize stage after CLAHE over (..., H, W) float32 on the u8
    grid -> bool ridge mask: kernel F -> B "remove_small" (4-connected) ->
    ``fill_holes_phase2`` -> kernel G. ``cc_iters`` is kept for signature
    parity only: every pass runs to its fixpoint."""
    del cc_iters
    fg = binarize_foreground(img_eq, win, k, patch)
    kept = cc_filter(fg, "remove_small", 1, min_size=min_size)
    return open_erode_reconstruct(fill_holes_phase2(kept, max_size))


def binarize_fused(img_eq: torch.Tensor, win: int = 25, k: float = 0.25,
                   patch: int = 32, min_size: int = 80, max_size: int = 150,
                   cc_iters: int = 512) -> torch.Tensor:
    """The unsplit form: kernel F -> B "clean" (one launch, both label
    passes) -> kernel G. Same mask as ``binarize_fused_split``."""
    del cc_iters
    fg = binarize_foreground(img_eq, win, k, patch)
    cleaned = cc_filter(fg, "clean", 1, min_size=min_size, max_size=max_size)
    return open_erode_reconstruct(cleaned)
