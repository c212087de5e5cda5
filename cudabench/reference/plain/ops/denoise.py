# Frozen copy of the port's ``ops/denoise.py`` for the benchmark's reference:
# the CUDA wrappers are removed and every dispatcher calls the plain
# twin on any device. Edit only to follow a change of semantics.
"""Non-local means denoising and the bilateral filter (port of
``ops/denoise.py``).

cv2.fastNlMeansDenoising(h=10, template=7, search=21) semantics over a
reflect-padded 21x21 search window and a 7x7 template. In the default
``precision="bf16"`` the per-offset SSD and weights round to bfloat16 at
the same points as the JAX package's form (input, difference, square, the
SSD after each box axis, the weight after exp, the weighted sample) and
accumulate in float32.

``nlm_denoise`` dispatches on the tensor's device: CPU tensors run the
plain twin ``nlm_denoise_plain`` (the 21 column offsets of each search row
as one batched tensor), CUDA tensors launch kernel E
(``ops.cuda_nlm.nlm_denoise_cuda``, ``csrc/nlm.cu``); anything else raises.
``nlm_denoise_sym`` and ``nlm_denoise_blocked`` are the JAX package's two
kernel entry points; on the card both are kernel E, which visits every
offset in the twin's order and so needs neither the mirror-offset reuse nor
the border-ring recompute that shaped the TPU forms.

``bilateral_filter`` is plain PyTorch on every device. Its range weight
divides by a float32 tensor: on CUDA a division by a Python scalar is a
multiplication by its reciprocal, one ulp off.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import _pad_axis


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _box_sum(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Sum of ``size`` neighbours along ``axis`` (numpy "symmetric" border),
    added in tap order."""
    n = x.shape[axis]
    c = size // 2
    p = _pad_axis(x, axis % x.ndim, c, size - 1 - c, "reflect")
    out = p.narrow(axis, 0, n)
    for t in range(1, size):
        out = out + p.narrow(axis, t, n)
    return out


def nlm_denoise_plain(x: torch.Tensor, h: float = 10.0,
                      template_window: int = 7, search_window: int = 21,
                      precision: str = "bf16") -> torch.Tensor:
    """Plain PyTorch twin of kernel E over (..., H, W) in [0,1];
    ``precision`` "bf16" (default) or "f32"."""
    rnd = _bf16 if precision == "bf16" else (lambda t: t)
    hn = h / 255.0
    r = search_window // 2
    hh, ww = x.shape[-2:]
    xc = rnd(x.to(torch.float32))
    # jnp.pad mode="reflect" is numpy's reflect, i.e. the "mirror" rule
    pad = _pad_axis(_pad_axis(xc, xc.ndim - 2, r, r, "mirror"),
                    xc.ndim - 1, r, r, "mirror")
    inv = -1.0 / (hn * hn) / float(template_window ** 2)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    wacc = torch.zeros_like(acc)
    xq = xc.unsqueeze(-3)                                    # (..., 1, H, W)
    for dy in range(search_window):
        strip = pad[..., dy:dy + hh, :]                      # (..., H, W+2r)
        # (..., search_window, H, W): every column offset of this row
        shifted = strip.unfold(-1, ww, 1).movedim(-2, -3)
        diff = rnd(xq - shifted)
        d2 = rnd(_box_sum(rnd(diff * diff), template_window, -2))
        d2 = _box_sum(d2, template_window, -1)
        wgt = rnd(torch.exp(d2 * inv))
        term = rnd(wgt * shifted)
        for dx in range(search_window):      # accumulate in offset order
            acc = acc + term[..., dx, :, :]
            wacc = wacc + wgt[..., dx, :, :]
    return acc / torch.clamp(wacc, min=1e-8)


def nlm_denoise(x: torch.Tensor, h: float = 10.0, template_window: int = 7,
                search_window: int = 21,
                precision: str = "bf16") -> torch.Tensor:
    """Non-local means over (..., H, W) in [0,1]; ``precision`` "bf16"
    (default) or "f32". CUDA tensors run kernel E; CPU tensors its plain
    twin."""
    return nlm_denoise_plain(x, h, template_window, search_window, precision)


def nlm_denoise_sym(img: torch.Tensor, h: float = 10.0, template: int = 7,
                    search: int = 21,
                    precision: str = "bf16") -> torch.Tensor:
    """(B, H, W) non-local means, the entry point named after the JAX
    package's symmetric-pair kernel (any frame size, no ring pass)."""
    return nlm_denoise(img, h, template, search, precision)


def nlm_denoise_blocked(img: torch.Tensor, h: float = 10.0, template: int = 7,
                        search: int = 21,
                        precision: str = "bf16") -> torch.Tensor:
    """(B, H, W) non-local means, the entry point named after the JAX
    package's offset-blocked kernel."""
    return nlm_denoise(img, h, template, search, precision)


def bilateral_filter(x: torch.Tensor, d: int = 5, sigma_color: float = 50.0,
                     sigma_space: float = 7.0) -> torch.Tensor:
    """Bilateral filter (cv2.bilateralFilter semantics) over (..., H, W)."""
    sc = sigma_color / 255.0
    r = d // 2
    hh, ww = x.shape[-2:]
    # jnp.pad mode="reflect" is numpy's reflect, i.e. the "mirror" rule
    pad = _pad_axis(_pad_axis(x, x.ndim - 2, r, r, "mirror"),
                    x.ndim - 1, r, r, "mirror")
    two_sc2 = torch.full((), 2.0 * sc ** 2, dtype=x.dtype, device=x.device)
    acc = torch.zeros_like(x)
    wacc = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = pad[..., r + dy:r + dy + hh, r + dx:r + dx + ww]
            ws = float(np.float32(np.exp(-(dy * dy + dx * dx)
                                         / (2.0 * sigma_space ** 2))))
            wc = torch.exp(-((x - shifted) ** 2) / two_sc2)
            w = ws * wc
            acc = acc + w * shifted
            wacc = wacc + w
    return acc / torch.clamp(wacc, min=1e-8)
