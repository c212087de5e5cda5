"""The binarize tail: kernel G (``csrc/morph.cu``) and its plain twins.

3x3-cross opening, a 3x3-cross eroded marker, and binary reconstruction by
dilation (8-connected) of the marker inside the opened mask. Replaces the
TPU kernel ``ops/pallas_bitpack.py:open_erode_reconstruct_packed``, which ran
the stencils and the reachability fixpoint on 32 images per int32 plane.
The reconstruction returns the opened mask whatever the input (the eroded
mask lies inside the marker, so one dilation of the marker covers the
opening; the argument is in the kernel's source), so on the card kernel G
computes the cross opening alone, in one pass: 32 pixels of a row to a word,
a block a band of rows with halos, any H, W >= 1. It is bound by the mask's
bytes.

``open_erode_reconstruct`` dispatches on the device: CPU tensors run
``open_erode_reconstruct_plain``, CUDA tensors launch the kernel; anything
else raises. ``open_cross_words_plain`` is the kernel's word algebra in
PyTorch (bands, halos, funnel shifts, padding bits); no path uses it, it
holds that algebra to the twin where the kernel cannot run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import build as _build
from ..utils.profiling import count
from .cuda_thin import pack_words, unpack_words
from .morphology import (binary_erode, binary_opening,
                         binary_reconstruction_by_dilation)

# the kernel's band height and strip width (csrc/morph.cu kRows, kWords)
_ROWS = 32
_WORDS = 8


def open_erode_reconstruct_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin over (..., H, W) masks; returns bool."""
    opened = binary_opening(mask, 3, shape="ellipse")      # ellipse 3 = cross
    marker = binary_erode(opened, 3, shape="ellipse")
    return binary_reconstruction_by_dilation(marker, opened)


def _east(c, r):
    """Bit i takes bit i + 1 of ``c``, bit 31 takes bit 0 of ``r``."""
    return ((c >> 1) & 0x7FFFFFFF) | ((r & 1) << 31)


def _west(lf, c):
    """Bit i takes bit i - 1 of ``c``, bit 0 takes bit 31 of ``lf``."""
    return (c << 1) | ((lf >> 31) & 1)


def _erode(n, c, s, lf, r):
    return c & n & s & _east(c, r) & _west(lf, c)


def _dilate(n, c, s, lf, r):
    return c | n | s | _east(c, r) | _west(lf, c)


def _open_cross_words(planes: torch.Tensor, w: int, rows: int = _ROWS,
                      words: int = _WORDS) -> torch.Tensor:
    """Kernel G on (B, H, ceil(w/32)) int32 words of rows of ``w`` pixels,
    a band of ``rows`` rows and a strip of ``words`` words at a time, term by
    term as the kernel takes them. Padding bits of the input are read as 0
    (the kernel's loads read no byte beyond a row's end); then the last real
    pixel of a row erodes to 0 (the border is background), so no padding bit
    of the output is set either."""
    nb, h, wd = planes.shape
    real = torch.full((wd,), -1, dtype=torch.int32, device=planes.device)
    if w % 32:
        real[-1] = (1 << (w % 32)) - 1
    # two zero rows above and below the frame, one zero word left and right
    pad = F.pad(planes & real, (1, 1, 2, 2))
    out = torch.empty_like(planes)
    for y0 in range(0, h, rows):
        for k0 in range(0, wd, words):
            nr, kw = min(rows, h - y0), min(words, wd - k0)
            tile = pad[:, y0:y0 + nr + 4, k0:k0 + kw + 2]  # halos included

            def at(dy, dk):
                return tile[:, 2 + dy:2 + dy + nr, 1 + dk:1 + dk + kw]

            zero = torch.zeros_like(at(0, 0))
            up = _erode(at(-2, 0), at(-1, 0), at(0, 0), at(-1, -1), at(-1, 1))
            mid = _erode(at(-1, 0), at(0, 0), at(1, 0), at(0, -1), at(0, 1))
            dn = _erode(at(0, 0), at(1, 0), at(2, 0), at(1, -1), at(1, 1))
            # only bit 31 of the left word and bit 0 of the right one count
            el = _erode(at(-1, -1), at(0, -1), at(1, -1), zero, at(0, 0))
            er = _erode(at(-1, 1), at(0, 1), at(1, 1), at(0, 0), zero)
            out[:, y0:y0 + nr, k0:k0 + kw] = _dilate(up, mid, dn, el, er)
    return out


def open_cross_words_plain(mask: torch.Tensor, rows: int = _ROWS,
                           words: int = _WORDS) -> torch.Tensor:
    """Kernel G's design in PyTorch: pack each row 32 pixels to an int32
    word, take the cross opening band by band with the kernel's halos and
    funnel shifts, unpack. Same contract as ``open_erode_reconstruct_plain``."""
    h, w = mask.shape[-2:]
    planes = pack_words(mask.reshape(-1, h, w) != 0)
    out = _open_cross_words(planes, w, rows, words)
    return unpack_words(out, w).reshape(mask.shape)


def open_erode_reconstruct_cuda(mask: torch.Tensor) -> torch.Tensor:
    """Kernel G on a CUDA (..., H, W) mask, any H, W >= 1; same contract as
    the plain twin."""
    if mask.device.type != "cuda":
        raise ValueError("open_erode_reconstruct_cuda needs a CUDA tensor, "
                         f"got {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError("open_erode_reconstruct_cuda needs a bool/uint8 mask, "
                        f"got {mask.dtype}")
    if mask.dim() < 2 or mask.shape[-2] < 1 or mask.shape[-1] < 1:
        raise ValueError(f"need (..., H, W) with H, W >= 1, got "
                         f"{tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        mask = mask != 0                 # the kernel packs bytes that are 0 or 1
    h, w = mask.shape[-2:]
    flat = mask.reshape(-1, h, w).contiguous()
    b = flat.shape[0]
    if b == 0 or b >= 2 ** 31:
        raise ValueError(f"batch {b} out of range")
    out = torch.empty((b, h, w), dtype=torch.bool, device=mask.device)
    rc = _build.load_library().mbfp_open_erode_reconstruct(
        flat.data_ptr(), out.data_ptr(), b, h, w,
        _build.current_stream(mask))
    _build.check(rc, "mbfp_open_erode_reconstruct")
    count("kernel.morph")
    return out.reshape(mask.shape)


def open_erode_reconstruct(mask: torch.Tensor,
                           max_iters: int = 512) -> torch.Tensor:
    """3x3-cross open -> 3x3-cross erode marker -> reconstruction by
    dilation over (..., H, W) masks -> bool, to the true fixpoint, which is
    the opening itself (``max_iters`` is kept for signature parity only)."""
    del max_iters
    if mask.device.type == "cpu":
        return open_erode_reconstruct_plain(mask)
    return open_erode_reconstruct_cuda(mask.to(torch.bool))
