# Frozen copy of the port's ``ops/morphology.py`` for the benchmark's reference:
# the CUDA wrappers are removed and every dispatcher calls the plain
# twin on any device. Edit only to follow a change of semantics.
"""Morphology (port of ``ops/morphology.py``).

Binary dilation and erosion are OR / AND over the structuring element's
offsets with a zero-filled border (the border behaves as background, as in
the JAX package); greyscale dilation and erosion are max / min with the
border filled by -inf / +inf (it never wins), on float32. Each SE row is a
contiguous run, so the reduce runs once per distinct run along x and is
then shifted along y; min and max are exact, so the order is free. Binary
geodesic reconstruction is marker reachability through ``ops.cuda_cc``
(kernel B on CUDA); the greyscale one iterates a 3x3 dilation under the
mask to its fixpoint, as the JAX package's loop does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_cc import cc_filter


def ellipse_se(size: int) -> np.ndarray:
    """OpenCV-style elliptical structuring element
    (cv2.getStructuringElement(MORPH_ELLIPSE, (size, size)))."""
    r = size / 2.0
    inv_r = 1.0 / max(r - 0.5, 1e-6)
    se = np.zeros((size, size), dtype=bool)
    for i in range(size):
        dy = i - (size - 1) / 2.0
        dx_max = (r - 0.5) * np.sqrt(max(0.0, 1.0 - (dy * inv_r) ** 2))
        j0 = int(np.ceil((size - 1) / 2.0 - dx_max))
        j1 = int(np.floor((size - 1) / 2.0 + dx_max))
        se[i, j0:j1 + 1] = True
    return se


def _se(size: int, shape: str) -> np.ndarray:
    return np.ones((size, size), bool) if shape == "rect" else ellipse_se(size)


def _run_reduce(p: torch.Tensor, se: np.ndarray, h: int, w: int, op
                ) -> torch.Tensor:
    """``op`` over the SE's offsets of the padded ``p``: out[y, x] reduces
    p[y + dy, x + dx] over the SE's (dy, dx), one horizontal reduce per
    distinct row run."""
    runs: dict[tuple[int, int], list[int]] = {}
    for i in range(se.shape[0]):
        js = np.nonzero(se[i])[0]
        if js.size:
            runs.setdefault((int(js[0]), int(js[-1])), []).append(i)
    out = None
    for (a, b), rows in runs.items():
        hred = p[..., :, a:a + w]
        for dx in range(a + 1, b + 1):
            hred = op(hred, p[..., :, dx:dx + w])
        for dy in rows:
            piece = hred[..., dy:dy + h, :]
            out = piece if out is None else op(out, piece)
    return out


def _se_reduce(mask: torch.Tensor, se: np.ndarray, dilate: bool) -> torch.Tensor:
    """OR (dilate) or AND (erode) of ``mask`` over the SE's offsets, zero
    fill outside the image."""
    m = mask.to(torch.bool)
    size_h, size_w = se.shape
    ch, cw = size_h // 2, size_w // 2
    h, w = m.shape[-2:]
    p = F.pad(m.to(torch.uint8), (cw, size_w - 1 - cw, ch, size_h - 1 - ch)
              ).to(torch.bool)
    return _run_reduce(p, se, h, w,
                       torch.logical_or if dilate else torch.logical_and)


def _grey_reduce(x: torch.Tensor, se: np.ndarray, dilate: bool,
                 before: tuple[int, int]) -> torch.Tensor:
    """max (dilate) or min (erode) of float32 ``x`` over the SE's offsets,
    ``before`` rows and columns of -inf / +inf padding before the image
    (the rest after)."""
    x = x.to(torch.float32)
    size_h, size_w = se.shape
    (bh, bw), (h, w) = before, x.shape[-2:]
    p = F.pad(x, (bw, size_w - 1 - bw, bh, size_h - 1 - bh),
              value=-float("inf") if dilate else float("inf"))
    return _run_reduce(p, se, h, w, torch.maximum if dilate else torch.minimum)


def _grey(x: torch.Tensor, size: int, shape: str, dilate: bool) -> torch.Tensor:
    if shape == "rect":     # the JAX reduce_window's "SAME" padding
        return _grey_reduce(x, _se(size, shape), dilate,
                            ((size - 1) // 2, (size - 1) // 2))
    se = ellipse_se(size)   # the JAX shift-and-reduce's padding
    return _grey_reduce(x, se, dilate, (se.shape[0] // 2, se.shape[1] // 2))


def dilate(x: torch.Tensor, size: int = 3, shape: str = "rect") -> torch.Tensor:
    """Greyscale dilation (max over the SE), float32 out."""
    return _grey(x, size, shape, dilate=True)


def erode(x: torch.Tensor, size: int = 3, shape: str = "rect") -> torch.Tensor:
    """Greyscale erosion (min over the SE), float32 out."""
    return _grey(x, size, shape, dilate=False)


def opening(x: torch.Tensor, size: int = 3, shape: str = "rect") -> torch.Tensor:
    return dilate(erode(x, size, shape), size, shape)


def closing(x: torch.Tensor, size: int = 3, shape: str = "rect") -> torch.Tensor:
    return erode(dilate(x, size, shape), size, shape)


def reconstruction_by_dilation(marker: torch.Tensor, mask: torch.Tensor,
                               max_iters: int = 256) -> torch.Tensor:
    """Greyscale geodesic reconstruction by dilation
    (skimage.morphology.reconstruction): marker <- min(dilate3x3(marker),
    mask) until nothing changes in the batch or ``max_iters`` dilations.
    Requires marker <= mask."""
    mask = mask.to(torch.float32)
    prev = torch.minimum(marker.to(torch.float32), mask)
    m = torch.minimum(dilate(prev, 3), mask)
    i = 1
    while i < max_iters and bool((m != prev).any()):
        prev, m = m, torch.minimum(dilate(m, 3), mask)
        i += 1
    return m


def binary_dilate(mask: torch.Tensor, size: int = 3,
                  shape: str = "rect") -> torch.Tensor:
    """Binary dilation: OR over SE-covered neighbours."""
    return _se_reduce(mask, _se(size, shape), dilate=True)


def binary_erode(mask: torch.Tensor, size: int = 3,
                 shape: str = "rect") -> torch.Tensor:
    """Binary erosion: AND over SE-covered neighbours; the border behaves
    as background."""
    return _se_reduce(mask, _se(size, shape), dilate=False)


def binary_opening(mask: torch.Tensor, size: int = 3,
                   shape: str = "rect") -> torch.Tensor:
    return binary_dilate(binary_erode(mask, size, shape), size, shape)


def binary_closing(mask: torch.Tensor, size: int = 3,
                   shape: str = "rect") -> torch.Tensor:
    return binary_erode(binary_dilate(mask, size, shape), size, shape)


def binary_close_open_packed(mask: torch.Tensor, size: int,
                             shape: str = "ellipse") -> torch.Tensor:
    """closing(size) then opening(size). The JAX package bit-packs 32 masks
    per int32 plane for the TPU; the result is the same, so the port runs
    the plain boolean form."""
    return binary_opening(binary_closing(mask, size, shape), size, shape)


def binary_reconstruction_by_dilation(marker: torch.Tensor, mask: torch.Tensor,
                                      max_iters: int = 32,
                                      substeps: int = 8) -> torch.Tensor:
    """Binary geodesic reconstruction by dilation (3x3, i.e. 8-connected):
    the components of ``mask`` that contain a pixel of ``marker & mask``.
    Computed to the true fixpoint; ``max_iters`` and ``substeps`` are kept
    for signature parity only."""
    del max_iters, substeps
    return cc_filter(mask.to(torch.bool), "reach", 2,
                     marker=marker.to(torch.bool))
