"""Orientation-steered Gabor ridge enhancement (port of ``ops/gabor.py``).

A bank of oriented (and, per block, frequency-tuned) even Gabor kernels is
convolved with the image, and each pixel takes the response of the kernel
that matches its quantized local orientation (and its block's quantized
ridge frequency). Ridge frequency is estimated per block, or globally, from
the magnitude spectrum within the plausible ridge-wavelength band.

The JAX package computes the bank outside any Pallas kernel. On the CPU the
port convolves with ``filters.conv2d_same``, the tap-by-tap form, whose
order of additions is the JAX ``conv2d_same``'s, and selects with the JAX
package's ``where`` loop. On the card the whole bank is one cuDNN
convolution with the kernels as output channels (in full float32: see
``preprocessing.enhance.exact_float32``) and the selection one ``gather``
on the bank axis: every pixel has exactly one bin, so it is the same
selection. The bin arithmetic divides by tensors: on CUDA a division by a
Python scalar is a multiplication by its reciprocal, one ulp off, which
can move a pixel across a bin edge.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .filters import _pad_axis, conv2d_same


def gabor_kernel(theta: float, freq: float, sigma_x: float = 4.0,
                 sigma_y: float = 4.0, size: int = 11) -> np.ndarray:
    """Even-symmetric Gabor kernel tuned to ridges at orientation theta."""
    half = size // 2
    ys, xs = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float32)
    # rotate coordinates so x' runs across the ridges
    xr = xs * np.cos(theta + np.pi / 2) + ys * np.sin(theta + np.pi / 2)
    yr = -xs * np.sin(theta + np.pi / 2) + ys * np.cos(theta + np.pi / 2)
    env = np.exp(-0.5 * ((xr / sigma_x) ** 2 + (yr / sigma_y) ** 2))
    wave = np.cos(2.0 * np.pi * freq * xr)
    k = env * wave
    return (k - k.mean()).astype(np.float32)


def _orientation_bins(orientation: torch.Tensor,
                      n_orientations: int) -> torch.Tensor:
    """round((orientation + pi/2) / (pi / n)) mod n, int64; the divisor is
    a float32 tensor on the orientation's device (a true division)."""
    width = torch.full((), np.pi / n_orientations, dtype=torch.float32,
                       device=orientation.device)
    idx = torch.round((orientation.to(torch.float32) + np.pi / 2) / width)
    return torch.remainder(idx.to(torch.int64), n_orientations)


def _bank_select(img: torch.Tensor, kernels: list, sel: torch.Tensor
                 ) -> torch.Tensor:
    """out[p] = (img correlated with kernels[sel[p]])[p], reflect border.

    CPU: the JAX package's loop, one ``conv2d_same`` and one ``where`` a
    kernel. CUDA: one convolution with the bank as output channels and one
    gather on the bank axis."""
    x = img.to(torch.float32)
    if x.device.type == "cpu":
        out = torch.zeros_like(x)
        for i, k in enumerate(kernels):
            out = torch.where(sel == i, conv2d_same(x, k), out)
        return out
    size = kernels[0].shape[0]
    ph = size // 2
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    flat = x.reshape(-1, 1, h, w)
    padded = _pad_axis(_pad_axis(flat, 2, ph, size - 1 - ph, "reflect"),
                       3, ph, size - 1 - ph, "reflect")
    weight = torch.from_numpy(np.stack(kernels)[:, None]).to(x.device)
    bank = F.conv2d(padded, weight)                      # (N, K, H, W)
    idx = sel.expand(lead + (h, w)).reshape(-1, 1, h, w)
    return bank.gather(1, idx).reshape(lead + (h, w))


def gabor_enhance(img: torch.Tensor, orientation: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  freq: float = 1.0 / 9.0,
                  n_orientations: int = 16,
                  size: int = 11) -> torch.Tensor:
    """Enhance (..., H, W) ridges using the per-pixel orientation field
    (angles in [-pi/2, pi/2)). Returns the filtered image, zeroed outside
    ``mask`` when given."""
    thetas = np.pi * (np.arange(n_orientations) / n_orientations) - np.pi / 2
    kernels = [gabor_kernel(float(th), freq, size=size) for th in thetas]
    out = _bank_select(img, kernels,
                       _orientation_bins(orientation, n_orientations))
    if mask is not None:
        out = torch.where(mask, out, torch.zeros_like(out))
    return out


def _band(fr: np.ndarray, min_wavelength: float,
          max_wavelength: float) -> np.ndarray:
    return (fr >= 1.0 / max_wavelength) & (fr <= 1.0 / min_wavelength)


def estimate_ridge_frequency_blockwise(img: torch.Tensor,
                                       mask: torch.Tensor | None = None,
                                       block_size: int = 32,
                                       min_wavelength: float = 4.0,
                                       max_wavelength: float = 16.0
                                       ) -> torch.Tensor:
    """Per-block ridge frequency map (..., H/B, W/B) in cycles/pixel.

    Each B x B block's dominant radial frequency within the plausible
    ridge-wavelength band, from the block's 2-D magnitude spectrum.
    Low-energy blocks (background) fall back to the image's energy-weighted
    mean frequency."""
    b = block_size
    h, w = img.shape[-2:]
    assert h % b == 0 and w % b == 0, (h, w, b)
    lead = img.shape[:-2]
    x = img.to(torch.float32)
    if mask is not None:
        x = torch.where(mask, x, torch.zeros_like(x))
    blocks = x.reshape(lead + (h // b, b, w // b, b)).transpose(-3, -2)
    blocks = blocks - blocks.mean(dim=(-2, -1), keepdim=True)

    spec = torch.fft.rfft2(blocks).abs()             # (..., Hb, Wb, b, b/2+1)
    # the JAX code's numpy float64 frequencies, rounded to float32 once
    fy = np.fft.fftfreq(b)[:, None]
    fx = np.fft.rfftfreq(b)[None, :]
    fr = np.sqrt(fy * fy + fx * fx).astype(np.float32)
    band = torch.from_numpy(_band(fr, min_wavelength, max_wavelength)
                            ).to(x.device)
    spec = torch.where(band, spec, torch.zeros_like(spec))

    flat = spec.reshape(spec.shape[:-2] + (-1,))
    peak_val = flat.amax(dim=-1)
    peak_idx = flat.argmax(dim=-1)                   # the first maximum
    freq = torch.from_numpy(fr.reshape(-1)).to(x.device)[peak_idx]

    # Fallback for low-energy blocks: energy-weighted mean of the rest.
    wgt = peak_val.reshape(lead + (-1,))
    f_flat = freq.reshape(lead + (-1,))
    mean_f = ((wgt * f_flat).sum(dim=-1)
              / torch.clamp(wgt.sum(dim=-1), min=1e-6))
    thresh = 0.1 * peak_val.amax(dim=(-2, -1), keepdim=True)
    return torch.where(peak_val > thresh, freq, mean_f.reshape(lead + (1, 1)))


def gabor_enhance_blockfreq(img: torch.Tensor, orientation: torch.Tensor,
                            freq_map: torch.Tensor,
                            mask: torch.Tensor | None = None,
                            n_orientations: int = 12,
                            n_frequencies: int = 4,
                            min_freq: float = 1.0 / 16.0,
                            max_freq: float = 1.0 / 4.0,
                            size: int = 11) -> torch.Tensor:
    """Gabor enhancement with a per-block frequency map: the bank spans
    n_orientations x n_frequencies kernels; each pixel selects by its
    quantized orientation and its block's quantized frequency."""
    h, w = img.shape[-2:]
    hb, wb = freq_map.shape[-2:]
    fbins = np.geomspace(min_freq, max_freq, n_frequencies).astype(np.float32)
    # the nearest bin per block, then nearest-neighbour up to pixels (the
    # JAX code upsamples first; the argmin is elementwise, so the same)
    fidx = (freq_map.to(torch.float32)[..., None]
            - torch.from_numpy(fbins).to(freq_map.device)).abs().argmin(dim=-1)
    fidx = fidx.repeat_interleave(h // hb, dim=-2).repeat_interleave(
        w // wb, dim=-1)
    oidx = _orientation_bins(orientation, n_orientations)

    thetas = np.pi * (np.arange(n_orientations) / n_orientations) - np.pi / 2
    # the JAX loop's order: frequency outer, orientation inner
    kernels = [gabor_kernel(float(th), float(fq), size=size)
               for fq in fbins for th in thetas]
    out = _bank_select(img, kernels, fidx * n_orientations + oidx)
    if mask is not None:
        out = torch.where(mask, out, torch.zeros_like(out))
    return out


def _freqs_f32(n: int, real: bool) -> np.ndarray:
    """``jnp.fft.fftfreq`` (``rfftfreq`` if ``real``) of length ``n`` in
    float32, the JAX code's own: integer bins divided by n in float32."""
    if real:
        k = np.arange(n // 2 + 1, dtype=np.float32)
    else:
        i = np.arange(n, dtype=np.float32)
        k = ((i + n // 2) % n - n // 2).astype(np.float32)
    return k / np.float32(n)


def estimate_ridge_frequency(img: torch.Tensor, orientation: torch.Tensor,
                             mask: torch.Tensor | None = None,
                             min_wavelength: float = 4.0,
                             max_wavelength: float = 16.0) -> torch.Tensor:
    """Global ridge frequency per image via the magnitude spectrum of the
    (masked) image: the dominant radial frequency within the plausible
    ridge-wavelength band. Returns (...,) cycles/pixel."""
    del orientation          # unused, as in the JAX package
    x = img.to(torch.float32)
    if mask is not None:
        x = torch.where(mask, x, torch.zeros_like(x))
    x = x - x.mean(dim=(-2, -1), keepdim=True)
    spec = torch.fft.rfft2(x).abs()
    h, w = x.shape[-2:]
    fy = _freqs_f32(h, False)[:, None]
    fx = _freqs_f32(w, True)[None, :]
    fr = np.sqrt(fy * fy + fx * fx)                  # float32 throughout
    band = torch.from_numpy(_band(fr, min_wavelength, max_wavelength)
                            ).to(x.device)
    spec = torch.where(band, spec, torch.zeros_like(spec))
    peak = spec.reshape(x.shape[:-2] + (-1,)).argmax(dim=-1)
    return torch.from_numpy(fr.reshape(-1)).to(x.device)[peak]
