"""Zhang-Suen thinning: kernel C (``csrc/thin.cu``) and its plain twins.

Replaces the TPU kernel ``ops/pallas_bitpack.py:zs_thin_bitpacked``, which
thinned 32 images per int32 plane inside VMEM. On the card the image is
packed 32 pixels of a row to a word, so a subpass is about 100 bitwise
operations per word (see the source). A frame whose two packed planes fit
one block's shared memory (up to about 960x960) stays in one block for the
whole fixpoint and crosses device memory once each way; a larger one keeps
its two planes in device memory, in scratch this wrapper allocates, with a
launch a subpass. Any H, W >= 1 is taken.

``zs_thin`` dispatches on the device: CPU tensors run ``zs_thin_plain``,
CUDA tensors launch the kernel; anything else raises.
``zs_thin_words_plain`` is the kernel's word algebra in PyTorch; no path
uses it, it holds that algebra to ``zs_thin_plain`` where the kernel cannot
run.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build as _build
from ..utils.profiling import count

_WORD = 32               # pixels of a row per packed word
# the kernel's forms: by frame size, one block an image, device memory
_FORMS = {"auto": 0, "block": 1, "device": 2}


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


def pack_words(mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W) mask -> (..., H, ceil(W/32)) int32 words; bit i of word k
    is pixel 32k + i of the row, the padding bits of the last word are 0."""
    w = mask.shape[-1]
    bits = F.pad(mask.to(torch.int64), (0, -w % _WORD))
    bits = bits.reshape(bits.shape[:-1] + (-1, _WORD))
    u = (bits << torch.arange(_WORD, device=mask.device)).sum(dim=-1)
    return (u - ((u >> 31) << 32)).to(torch.int32)    # as two's complement


def unpack_words(words: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of ``pack_words`` for rows of ``w`` pixels: a bool mask."""
    bits = (words[..., None] >> torch.arange(_WORD, device=words.device)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :w].to(torch.bool)


def _word_ring(c: torch.Tensor) -> list[torch.Tensor]:
    """The neighbour planes [P2..P9] of (..., H, Wd) words: the rows above
    and below, and one-bit shifts that carry in the edge bit of the word to
    the left or right (zeros at the frame's border)."""
    pad = F.pad(c, (1, 1, 1, 1))
    h, wd = c.shape[-2:]

    def at(dy, dk):
        return pad[..., 1 + dy:1 + dy + h, 1 + dk:1 + dk + wd]

    def east(dy):     # bit i takes pixel i + 1: a logical shift right
        return ((at(dy, 0) >> 1) & 0x7FFFFFFF) | ((at(dy, 1) & 1) << 31)

    def west(dy):
        return (at(dy, 0) << 1) | ((at(dy, -1) >> 31) & 1)

    return [at(-1, 0), east(-1), east(0), east(1),
            at(1, 0), west(1), west(0), west(-1)]


def _maj(a, b, c):
    return (a & b) | (c & (a ^ b))


def _words_subpass(c: torch.Tensor, first: bool) -> torch.Tensor:
    """One subpass on packed words, the kernel's algebra term by term."""
    p = _word_ring(c)
    p2, p3, p4, p5, p6, p7, p8, p9 = p
    # B = p2 + ... + p9 as bit planes b0, b1, b2 (B == 8 has b1 == b2 == 0)
    s0, c0 = p2 ^ p3 ^ p4, _maj(p2, p3, p4)
    s1, c1 = p5 ^ p6 ^ p7, _maj(p5, p6, p7)
    s2, c2 = p8 ^ p9, p8 & p9
    b0, d0 = s0 ^ s1 ^ s2, _maj(s0, s1, s2)
    u0, e0 = c0 ^ c1 ^ c2, _maj(c0, c1, c2)
    b1, e1 = u0 ^ d0, u0 & d0
    b2 = e0 ^ e1
    ok_b = (b1 | b2) & ~(b0 & b1 & b2)                 # 2 <= B <= 6
    one, two = torch.zeros_like(c), torch.zeros_like(c)
    for i in range(8):                                 # A == 1
        t = ~p[i] & p[(i + 1) & 7]
        two = two | (one & t)
        one = one | t
    prod = p4 & p6 & (p2 | p8) if first else p2 & p8 & (p4 | p6)
    return c & ~(ok_b & one & ~two & ~prod)


def zs_thin_words_plain(mask: torch.Tensor, max_iters: int = 128,
                        prune: bool = False) -> torch.Tensor:
    """Kernel C's design in PyTorch: pack each row 32 pixels to an int32
    word, thin with the bit-sliced subpass, each image to its own fixpoint
    or ``max_iters``, prune with one more bitwise pass, unpack. Same
    contract as ``zs_thin_plain``."""
    h, w = mask.shape[-2:]
    words = pack_words(mask.reshape(-1, h, w) != 0)
    live = torch.ones(words.shape[0], dtype=torch.bool, device=mask.device)
    for _ in range(max_iters):
        if not bool(live.any()):
            break
        new = _words_subpass(_words_subpass(words[live], True), False)
        changed = (new != words[live]).flatten(1).any(dim=1)
        words[live] = new
        live[live.clone()] = changed
    if prune:
        any_nbr = torch.zeros_like(words)
        for q in _word_ring(words):
            any_nbr |= q
        words &= any_nbr
    return unpack_words(words, w).reshape(mask.shape)


def zs_thin_cuda(mask: torch.Tensor, max_iters: int = 128,
                 prune: bool = False, form: str = "auto") -> torch.Tensor:
    """Kernel C on a CUDA (..., H, W) mask; same contract as the plain twin,
    for any H, W >= 1. ``form`` "auto" picks one block an image where the
    two packed planes fit its shared memory and device memory elsewhere;
    "block" and "device" ask for one (``chip_smoke.py`` holds both to the
    twin; "block" raises for a frame that does not fit)."""
    if mask.device.type != "cuda":
        raise ValueError(f"zs_thin_cuda needs a CUDA tensor, got {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"zs_thin_cuda needs a bool/uint8 mask, got {mask.dtype}")
    if form not in _FORMS:
        raise ValueError(f"form {form!r} is not one of {sorted(_FORMS)}")
    h, w = mask.shape[-2:]
    if h < 1 or w < 1:
        raise ValueError(f"{h}x{w} image: H and W must be >= 1")
    if mask.dtype != torch.bool:
        mask = mask != 0                 # the kernel packs bytes that are 0 or 1
    flat = mask.reshape(-1, h, w).contiguous()
    b = flat.shape[0]
    if b == 0 or b >= 2 ** 31:
        raise ValueError(f"batch {b} out of range")
    lib = _build.load_library()
    nbytes = ctypes.c_longlong(0)
    _build.check(lib.mbfp_zs_thin_scratch(b, h, w, _FORMS[form],
                                          ctypes.addressof(nbytes)),
                 "mbfp_zs_thin_scratch")
    if nbytes.value < 0:
        raise ValueError(f"{h}x{w} image: two packed planes do not fit one "
                         "block's shared memory (form 'block')")
    scratch = (torch.empty(nbytes.value, dtype=torch.uint8, device=mask.device)
               if nbytes.value else None)
    out = torch.empty((b, h, w), dtype=torch.bool, device=mask.device)
    rc = lib.mbfp_zs_thin(
        flat.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, h, w,
        int(max_iters), int(bool(prune)), _FORMS[form],
        _build.current_stream(mask))
    _build.check(rc, "mbfp_zs_thin")
    count("kernel.thin")
    return out.reshape(mask.shape)


def zs_thin(mask: torch.Tensor, max_iters: int = 128,
            prune: bool = False) -> torch.Tensor:
    if mask.device.type == "cpu":
        return zs_thin_plain(mask, max_iters, prune)
    return zs_thin_cuda(mask.to(torch.bool), max_iters, prune)
