"""The binarize tail: kernel G (``csrc/morph.cu``) and its plain twin.

3x3-cross opening, a 3x3-cross eroded marker, and binary reconstruction by
dilation (8-connected) of the marker inside the opened mask. Replaces the
TPU kernel ``ops/pallas_bitpack.py:open_erode_reconstruct_packed``, which ran
the stencils and the reachability fixpoint on 32 images per int32 plane. On
the card one block holds one image in shared memory for the three stencils
and the whole fixpoint, so the mask crosses device memory once each way; the
loop ends at the image's own fixpoint, with no sweep limit. The kernel is
bound by shared-memory traffic and block barriers (see the source).

``open_erode_reconstruct`` dispatches on the device: CPU tensors run
``open_erode_reconstruct_plain``, CUDA tensors launch the kernel; anything
else raises.
"""

from __future__ import annotations

import torch

from ..kernels import build as _build
from .morphology import (binary_erode, binary_opening,
                         binary_reconstruction_by_dilation)

_SMEM_LIMIT = 232448     # bytes of shared memory one Hopper block may use


def open_erode_reconstruct_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin over (..., H, W) masks; returns bool."""
    opened = binary_opening(mask, 3, shape="ellipse")      # ellipse 3 = cross
    marker = binary_erode(opened, 3, shape="ellipse")
    return binary_reconstruction_by_dilation(marker, opened)


def open_erode_reconstruct_cuda(mask: torch.Tensor) -> torch.Tensor:
    """Kernel G on a CUDA (..., H, W) mask; same contract as the plain twin."""
    if mask.device.type != "cuda":
        raise ValueError("open_erode_reconstruct_cuda needs a CUDA tensor, "
                         f"got {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError("open_erode_reconstruct_cuda needs a bool/uint8 mask, "
                        f"got {mask.dtype}")
    if mask.dim() < 2:
        raise ValueError(f"need (..., H, W), got {tuple(mask.shape)}")
    h, w = mask.shape[-2:]
    if h * w > _SMEM_LIMIT:
        raise ValueError(f"{h}x{w} image exceeds one block's shared memory")
    flat = mask.reshape(-1, h, w).contiguous()
    b = flat.shape[0]
    if b == 0 or b >= 2 ** 31:
        raise ValueError(f"batch {b} out of range")
    out = torch.empty((b, h, w), dtype=torch.bool, device=mask.device)
    rc = _build.load_library().mbfp_open_erode_reconstruct(
        flat.view(torch.uint8).data_ptr(), out.data_ptr(), b, h, w,
        _build.current_stream(mask))
    _build.check(rc, "mbfp_open_erode_reconstruct")
    _build.LAUNCHES["morph"] += 1
    return out.reshape(mask.shape)


def open_erode_reconstruct(mask: torch.Tensor,
                           max_iters: int = 512) -> torch.Tensor:
    """3x3-cross open -> 3x3-cross erode marker -> reconstruction by
    dilation over (..., H, W) masks -> bool, to the true fixpoint
    (``max_iters`` is kept for signature parity only)."""
    del max_iters
    if mask.device.type == "cpu":
        return open_erode_reconstruct_plain(mask)
    return open_erode_reconstruct_cuda(mask.to(torch.bool))
