"""Zhang-Suen thinning: kernel C (``csrc/thin.cu``) and its plain twin.

Replaces the TPU kernel ``ops/pallas_bitpack.py:zs_thin_bitpacked``, which
thinned 32 images per int32 plane inside VMEM. On the card one block holds
one image in shared memory for the whole fixpoint, so the image crosses
device memory once each way; the loop is bound by shared-memory traffic and
block barriers (see the source).

``zs_thin`` dispatches on the device: CPU tensors run ``zs_thin_plain``,
CUDA tensors launch the kernel; anything else raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build as _build

_SMEM_LIMIT = 232448     # bytes of shared memory one Hopper block may use


def _ring(x: torch.Tensor) -> list[torch.Tensor]:
    """8-neighbourhood [P2..P9] = N, NE, E, SE, S, SW, W, NW, zero border."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))

    def sh(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    return [sh(-1, 0), sh(-1, 1), sh(0, 1), sh(1, 1),
            sh(1, 0), sh(1, -1), sh(0, -1), sh(-1, -1)]


def _subpass(img: torch.Tensor, first: bool) -> torch.Tensor:
    p2, p3, p4, p5, p6, p7, p8, p9 = _ring(img)
    b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
    ring = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
    a = torch.zeros_like(img)
    for i in range(8):
        a = a + ((ring[i] == 0) & (ring[i + 1] == 1)).to(img.dtype)
    if first:
        c = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
    else:
        c = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
    remove = (img == 1) & (b >= 2) & (b <= 6) & (a == 1) & c
    return torch.where(remove, torch.zeros_like(img), img)


def prune_isolated_plain(skel: torch.Tensor) -> torch.Tensor:
    """Drop pixels with no 8-neighbour."""
    s = skel.to(torch.bool)
    any_nbr = torch.zeros_like(s)
    for q in _ring(s.to(torch.uint8)):
        any_nbr |= q.to(torch.bool)
    return s & any_nbr


def zs_thin_plain(mask: torch.Tensor, max_iters: int = 128,
                  prune: bool = False) -> torch.Tensor:
    """Plain PyTorch Zhang-Suen over (..., H, W) masks: two subpasses per
    iteration, batch-wide, until nothing changes or ``max_iters``."""
    img = mask.to(torch.int32)
    for _ in range(max_iters):
        new = _subpass(_subpass(img, True), False)
        done = torch.equal(new, img)
        img = new
        if done:
            break
    out = img.to(torch.bool)
    return prune_isolated_plain(out) if prune else out


def zs_thin_cuda(mask: torch.Tensor, max_iters: int = 128,
                 prune: bool = False) -> torch.Tensor:
    """Kernel C on a CUDA (..., H, W) mask; same contract as the plain twin."""
    if mask.device.type != "cuda":
        raise ValueError(f"zs_thin_cuda needs a CUDA tensor, got {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"zs_thin_cuda needs a bool/uint8 mask, got {mask.dtype}")
    h, w = mask.shape[-2:]
    if h * w > _SMEM_LIMIT:
        raise ValueError(f"{h}x{w} image exceeds one block's shared memory")
    flat = mask.reshape(-1, h, w).contiguous()
    b = flat.shape[0]
    if b == 0 or b >= 2 ** 31:
        raise ValueError(f"batch {b} out of range")
    out = torch.empty((b, h, w), dtype=torch.bool, device=mask.device)
    rc = _build.load_library().mbfp_zs_thin(
        flat.view(torch.uint8).data_ptr(), out.data_ptr(), b, h, w,
        int(max_iters), int(bool(prune)), _build.current_stream(mask))
    _build.check(rc, "mbfp_zs_thin")
    _build.LAUNCHES["thin"] += 1
    return out.reshape(mask.shape)


def zs_thin(mask: torch.Tensor, max_iters: int = 128,
            prune: bool = False) -> torch.Tensor:
    if mask.device.type == "cpu":
        return zs_thin_plain(mask, max_iters, prune)
    return zs_thin_cuda(mask.to(torch.bool), max_iters, prune)
