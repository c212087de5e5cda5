# Frozen copy of the port's ``ops/components.py`` for the benchmark's reference:
# the CUDA wrappers are removed and every dispatcher calls the plain
# twin on any device. Edit only to follow a change of semantics.
"""Connected components and mask-domain geometry (port of
``ops/components.py``).

Every labelling and size filter here goes through ``ops.cuda_cc``: kernel B
on CUDA tensors, its plain PyTorch twin on CPU tensors. Labels are int32,
the component's minimum linear index, background 2^30, always computed to
the true fixpoint (``max_iters`` is kept for signature parity only).

Convex hull: the intersection of the supporting half-planes over
``n_directions`` sampled angles, in the JAX package's row-interval form.
"""

from __future__ import annotations

import math

import torch

from .cuda_cc import cc_filter, cc_label


def connected_components(mask: torch.Tensor, connectivity: int = 2,
                         max_iters: int = 512) -> torch.Tensor:
    """Label the connected components of a boolean mask (..., H, W).

    Returns int32 labels: the linear index of each component's smallest
    pixel; background pixels get 2**30. connectivity: 1 (4-conn) or 2
    (8-conn)."""
    del max_iters
    shape = mask.shape
    flat = mask.reshape((-1,) + shape[-2:]).to(torch.bool)
    return cc_label(flat, connectivity).reshape(shape)


def component_sizes(label: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pixel count per component root: (..., H*W+1) float32; slot H*W
    counts the background."""
    h, w = label.shape[-2:]
    hw = h * w
    lead = label.shape[:-2]
    lab = torch.where(mask.to(torch.bool), label.to(torch.int64), hw)
    lab = lab.reshape(-1, hw)
    sizes = torch.zeros((lab.shape[0], hw + 1), dtype=torch.float32,
                        device=label.device)
    sizes.scatter_add_(1, lab, torch.ones(lab.shape, dtype=torch.float32,
                                          device=label.device))
    return sizes.reshape(lead + (hw + 1,))


def remove_small_objects(mask: torch.Tensor, min_size: int,
                         connectivity: int = 2) -> torch.Tensor:
    """Drop components smaller than min_size
    (skimage.morphology.remove_small_objects)."""
    return cc_filter(mask, "remove_small", connectivity, min_size=min_size)


def remove_small_holes(mask: torch.Tensor, max_size: int,
                       connectivity: int = 2) -> torch.Tensor:
    """Fill background components smaller than max_size
    (skimage.morphology.remove_small_holes)."""
    return cc_filter(mask, "fill_holes", connectivity, max_size=max_size)


def clean_mask(mask: torch.Tensor, min_size: int, max_size: int,
               connectivity: int = 1) -> torch.Tensor:
    """remove_small_objects(min_size) then remove_small_holes(max_size),
    in one kernel-B launch on CUDA."""
    return cc_filter(mask, "clean", connectivity, min_size=min_size,
                     max_size=max_size)


def largest_component(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Keep only the largest connected component; ties go to the component
    with the smallest label."""
    return cc_filter(mask, "largest", connectivity)


def convex_hull_mask(mask: torch.Tensor, n_directions: int = 90,
                     pad: float = 0.5) -> torch.Tensor:
    """Convex hull of a boolean mask as the intersection of supporting
    half-planes over ``n_directions`` sampled angles (replaces
    cv2.convexHull + fillPoly).

    Per row, each half-plane passes a prefix or suffix of x, so the hull row
    is an interval whose ends are found by binary search on the float32
    predicate cos*x + sin*y <= pmax + pad."""
    fg = mask.to(torch.bool)
    lead = mask.shape[:-2]
    h, w = mask.shape[-2:]
    fg3 = fg.reshape(-1, h, w)
    b = fg3.shape[0]
    dev = mask.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs_i = torch.arange(w, dtype=torch.int32, device=dev)
    thetas = (torch.arange(n_directions, dtype=torch.float32, device=dev)
              * torch.tensor(2.0 * math.pi / n_directions, dtype=torch.float32))
    cos, sin = torch.cos(thetas), torch.sin(thetas)           # (D,)

    any_fg = fg3.any(dim=-1).any(dim=-1)                      # (B,)
    row_any = fg3.any(dim=-1)                                 # (B, H)
    xmax_r = torch.where(fg3, xs_i, -1).amax(dim=-1)
    xmin_r = torch.where(fg3, xs_i, w).amin(dim=-1)

    xext = torch.where(cos[None, None, :] > 0.0, xmax_r[..., None],
                       xmin_r[..., None]).to(torch.float32)
    sy = sin[None, :] * ys[:, None]                           # (H, D)
    rowval = cos[None, None, :] * xext + sy[None]             # (B, H, D)
    rowval = torch.where(row_any[..., None], rowval,
                         torch.tensor(-math.inf, device=dev))
    thr = rowval.amax(dim=1) + pad                            # (B, D)

    def pred(x_int):
        x = x_int.to(torch.float32)
        return cos[None, None, :] * x + sy[None] <= thr[:, None, :]

    pos = cos > 0.0
    res_hi = torch.full((b, h, n_directions), -1, dtype=torch.int32, device=dev)
    res_lo = torch.full((b, h, n_directions), w, dtype=torch.int32, device=dev)
    bit = 1
    while bit * 2 <= w:
        bit *= 2
    while bit >= 1:
        cand_hi = res_hi + bit
        res_hi = torch.where((cand_hi <= w - 1) & pred(cand_hi), cand_hi, res_hi)
        cand_lo = res_lo - bit
        res_lo = torch.where((cand_lo >= 0) & pred(cand_lo), cand_lo, res_lo)
        bit //= 2

    xhi = torch.where(pos[None, None, :], res_hi, w - 1).amin(dim=-1)
    xlo = torch.where(pos[None, None, :], 0, res_lo).amax(dim=-1)
    inside = ((xs_i[None, None, :] >= xlo[..., None])
              & (xs_i[None, None, :] <= xhi[..., None])
              & any_fg[:, None, None])
    return inside.reshape(lead + (h, w))


def mask_bbox(mask: torch.Tensor) -> torch.Tensor:
    """(y0, x0, y1, x1) inclusive bounds of a boolean mask (empty mask ->
    (h, w, -1, -1), as in the JAX package). Replaces cv2.boundingRect."""
    fg = mask.to(torch.bool)
    h, w = mask.shape[-2:]
    ys = torch.arange(h, dtype=torch.int32, device=mask.device)
    xs = torch.arange(w, dtype=torch.int32, device=mask.device)
    row_any = fg.any(dim=-1)
    col_any = fg.any(dim=-2)
    y0 = torch.where(row_any, ys, h).amin(dim=-1)
    y1 = torch.where(row_any, ys, -1).amax(dim=-1)
    x0 = torch.where(col_any, xs, w).amin(dim=-1)
    x1 = torch.where(col_any, xs, -1).amax(dim=-1)
    return torch.stack([y0, x0, y1, x1], dim=-1)
