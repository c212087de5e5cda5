"""Connected components: kernel B (``csrc/cc.cu``) and its plain twin.

Replaces the TPU kernels of ``ops/pallas_cc.py`` (``cc_filter_pallas``,
``_split2_pallas`` behind ``clean_mask_split``, ``binary_reconstruct_pallas``,
``connected_components_pallas``) and ``reach_packed`` /
``border_reach_packed`` of ``ops/pallas_bitpack.py``. Every use computes one
function: label the components of a mask (or of its inverse), then keep or
drop pixels by a per-component property. The TPU split into canonical
components on bit-packed planes was a workaround for the TPU's scans; its
outputs equal the unsplit filter, which is what is computed here.

On the card the function is bound by bytes (a mask in, a mask out), and what
costs is atomics and dependent loads through L2. So a label pass works in
shared memory on 32x32 tiles: a mask row is one ballot word, the pixels of a
horizontal run share the run's first pixel as their label without any union,
runs of neighbouring rows unite in shared memory, and sizes or marker flags
are tallied per tile. Device memory sees unions only along the seams of the
tiles and one atomic add per tile and component; a pixel then reaches its
component's root in two loads (see the source).

Labels are int32: the component's minimum linear index, background 2^30.

``cc_label`` / ``cc_filter`` dispatch on the device: CPU tensors run the
plain PyTorch twin, CUDA tensors launch the kernel; anything else raises.
"""

from __future__ import annotations

import torch

from ..kernels import build as _build
from ..utils.profiling import count

BACKGROUND = 1 << 30
MODES = {"remove_small": 0, "fill_holes": 1, "clean": 2, "largest": 3,
         "reach": 4}


def _neighbor_min(lab: torch.Tensor, fg: torch.Tensor,
                  connectivity: int) -> torch.Tensor:
    """Min label over the pixel and its neighbours, over foreground only.
    lab: (B, H, W) int64 with background = H*W (a value above every label)."""
    b, h, w = lab.shape
    big = h * w
    x = torch.where(fg, lab, big)
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=big)
    offs = [(0, 1), (1, 0), (1, 2), (2, 1)]
    if connectivity == 2:
        offs += [(0, 0), (0, 2), (2, 0), (2, 2)]
    out = x
    for dy, dx in offs:
        out = torch.minimum(out, p[:, dy:dy + h, dx:dx + w])
    return torch.where(fg, out, big)


def cc_label_plain(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Plain PyTorch labelling of (B, H, W) bool masks: hook each root under
    the smallest neighbouring label (scatter amin), then pointer-jump, to
    the true fixpoint. Returns int32 labels (min linear index; bg 2^30)."""
    b, h, w = mask.shape
    hw = h * w
    fg = mask.to(torch.bool)
    idx = torch.arange(hw, device=mask.device).reshape(1, h, w)
    # slot hw is a sink for background pixels, so every pixel can index
    lab = torch.where(fg, idx, hw).reshape(b, hw)
    lab = torch.cat([lab, torch.full((b, 1), hw, device=mask.device,
                                     dtype=lab.dtype)], dim=1)
    while True:
        prev = lab
        m = _neighbor_min(lab[:, :hw].reshape(b, h, w), fg,
                          connectivity).reshape(b, hw)
        hooked = lab.clone()
        hooked.scatter_reduce_(1, lab[:, :hw], m, reduce="amin")
        lab = torch.minimum(hooked, torch.cat([m, lab[:, hw:]], dim=1))
        while True:
            jumped = torch.gather(lab, 1, lab)
            if torch.equal(jumped, lab):
                break
            lab = jumped
        if torch.equal(lab, prev):
            break
    out = lab[:, :hw].reshape(b, h, w)
    return torch.where(fg, out, BACKGROUND).to(torch.int32)


def _sizes_at(label: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Per-pixel size of the pixel's component (0 on background)."""
    b, h, w = label.shape
    lab = torch.where(fg, label.to(torch.int64), h * w).reshape(b, -1)
    sizes = torch.zeros((b, h * w + 1), dtype=torch.int64, device=label.device)
    sizes.scatter_add_(1, lab, torch.ones_like(lab))
    sizes[:, -1] = 0
    return torch.gather(sizes, 1, lab).reshape(b, h, w)


def cc_filter_plain(mask: torch.Tensor, mode: str, connectivity: int = 2,
                    min_size: int = 0, max_size: int = 0,
                    marker: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of kernel B on (B, H, W) masks; returns bool."""
    fg = mask.to(torch.bool)
    if mode in ("remove_small", "clean"):
        lab = cc_label_plain(fg, connectivity)
        fg = fg & (_sizes_at(lab, fg) >= min_size)
    if mode in ("fill_holes", "clean"):
        inv = ~fg
        lab = cc_label_plain(inv, connectivity)
        return fg | (inv & (_sizes_at(lab, inv) < max_size))
    if mode == "remove_small":
        return fg
    b, h, w = fg.shape
    lab = cc_label_plain(fg, connectivity)
    flat = torch.where(fg, lab.to(torch.int64), h * w).reshape(b, -1)
    if mode == "largest":
        sizes = torch.zeros((b, h * w + 1), dtype=torch.int64,
                            device=fg.device)
        sizes.scatter_add_(1, flat, torch.ones_like(flat))
        # torch.argmax returns the first maximal index: ties -> smallest label
        best = torch.argmax(sizes[:, :-1], dim=1)
        return fg & (lab.to(torch.int64) == best[:, None, None])
    if mode == "reach":
        hit = torch.zeros((b, h * w + 1), dtype=torch.int64, device=fg.device)
        seeds = (fg & marker.to(torch.bool)).reshape(b, -1).to(torch.int64)
        hit.scatter_reduce_(1, flat, seeds, reduce="amax")
        hit[:, -1] = 0
        return torch.gather(hit, 1, flat).reshape(b, h, w) > 0
    raise ValueError(mode)


def _check_mask(mask: torch.Tensor, name: str) -> None:
    if mask.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name} needs a bool/uint8 mask, got {mask.dtype}")
    if mask.dim() != 3:
        raise ValueError(f"{name} needs (B, H, W), got {tuple(mask.shape)}")
    b, h, w = mask.shape
    if b == 0 or b * h * w >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(mask.shape)} out of range")


def _u8(mask: torch.Tensor) -> torch.Tensor:
    return mask.contiguous().view(torch.uint8)


def cc_label_cuda(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Kernel B's labelling on a CUDA (B, H, W) mask -> int32 labels."""
    _check_mask(mask, "cc_label_cuda")
    b, h, w = mask.shape
    label = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
    m = _u8(mask)
    rc = _build.load_library().mbfp_cc_label(
        m.data_ptr(), 0, label.data_ptr(), b, h, w, connectivity,
        _build.current_stream(mask))
    _build.check(rc, "mbfp_cc_label")
    count("kernel.cc")
    return label


def cc_filter_cuda(mask: torch.Tensor, mode: str, connectivity: int = 2,
                   min_size: int = 0, max_size: int = 0,
                   marker: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel B on a CUDA (B, H, W) mask; same contract as the plain twin."""
    _check_mask(mask, "cc_filter_cuda")
    b, h, w = mask.shape
    m = _u8(mask)
    if mode == "reach":
        _check_mask(marker, "cc_filter_cuda marker")
        if marker.shape != mask.shape:
            raise ValueError("marker and mask shapes differ")
        mk = _u8(marker)
    else:
        mk = m
    dev = mask.device
    out = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    label = torch.empty((b, h * w), dtype=torch.int32, device=dev)
    table = torch.empty((b, h * w), dtype=torch.int32, device=dev)
    key = torch.empty((b,), dtype=torch.int64, device=dev)
    rc = _build.load_library().mbfp_cc_filter(
        m.data_ptr(), mk.data_ptr(), out.data_ptr(), label.data_ptr(),
        table.data_ptr(), key.data_ptr(), b, h, w, connectivity, MODES[mode],
        int(min_size), int(max_size), _build.current_stream(mask))
    _build.check(rc, "mbfp_cc_filter")
    count("kernel.cc")
    return out


def _check_connectivity(connectivity: int) -> None:
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")


def cc_label(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Int32 labels of (B, H, W) masks (min linear index; bg 2^30)."""
    _check_connectivity(connectivity)
    if mask.device.type == "cpu":
        return cc_label_plain(mask, connectivity)
    return cc_label_cuda(mask, connectivity)


def cc_filter(mask: torch.Tensor, mode: str, connectivity: int = 2,
              min_size: int = 0, max_size: int = 0,
              marker: torch.Tensor | None = None) -> torch.Tensor:
    """Label + per-component filter of (..., H, W) masks -> bool.

    mode: "remove_small" (min_size), "fill_holes" (max_size), "clean"
    (both, in sequence), "largest", "reach" (components holding a pixel of
    ``marker``). connectivity: 1 (4-conn) or 2 (8-conn)."""
    if mode not in MODES:
        raise ValueError(mode)
    _check_connectivity(connectivity)
    shape = mask.shape
    flat = mask.reshape((-1,) + shape[-2:])
    mk = None if marker is None else marker.reshape(flat.shape)
    if mask.device.type == "cpu":
        out = cc_filter_plain(flat, mode, connectivity, min_size, max_size, mk)
    else:
        out = cc_filter_cuda(flat.to(torch.bool), mode, connectivity,
                             min_size, max_size,
                             None if mk is None else mk.to(torch.bool))
    return out.reshape(shape)


def fill_holes_split(mask: torch.Tensor, max_size: int,
                     connectivity: int = 1,
                     max_iters: int = 512) -> torch.Tensor:
    """remove_small_holes(max_size): the entry point named after the JAX
    package's one-canonical-component split filter. That kernel took the
    border-connected background as packed planes so the TPU would not relax
    it per image; kernel B labels it tile by tile at no such cost, so this
    is B's "fill_holes" mode (``max_iters`` kept for signature parity
    only)."""
    del max_iters
    return cc_filter(mask, "fill_holes", connectivity, max_size=max_size)


def remove_small_split(mask: torch.Tensor, min_size: int,
                       connectivity: int = 1,
                       max_iters: int = 512) -> torch.Tensor:
    """remove_small_objects(min_size): the entry point named after the JAX
    package's centre-seeded split filter; kernel B's "remove_small" mode
    (``max_iters`` kept for signature parity only)."""
    del max_iters
    return cc_filter(mask, "remove_small", connectivity, min_size=min_size)
