"""The enhancement chain (port of ``preprocessing/enhance.py``):
normalize -> denoise -> segment -> orientation -> [Gabor] -> binarize ->
smooth -> thin.

Every stage consumes and produces batched (..., H, W) float32 tensors in
[0, 1] (masks bool) on the input's device. On a CUDA device the stages are
the JAX package's kernel-backed path: CLAHE (kernel A), non-local means (E),
the binarize front (F), connected components (B), the open/erode/reconstruct
tail (G) and thinning (C) are hand-written CUDA kernels, chosen by each
wrapper from the tensor's device; on the CPU the same functions run the
kernels' plain twins. There is no switch between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.components import clean_mask, convex_hull_mask, largest_component
from ..ops.cuda_binarize import binarize_fused_split
from ..ops.cuda_kernels import bin_to_unit
from ..ops.cuda_thin import zs_thin
from ..ops.denoise import nlm_denoise
from ..ops.filters import gaussian_blur, gaussian_blur_cv, sobel
from ..ops.gabor import (estimate_ridge_frequency_blockwise,
                         gabor_enhance_blockfreq)
from ..ops.histogram import clahe, otsu_threshold, percentile_stretch
from ..ops.morphology import binary_close_open_packed
from ..ops.orientation import OrientationField, compute_orientation_field
from ..utils.profiling import span, traced


class EnhancementResult(NamedTuple):
    """Stage images, as the JAX package returns them."""
    normalized: torch.Tensor   # [0,1]
    denoised: torch.Tensor     # [0,1]
    segmented: torch.Tensor    # [0,1], masked gray
    mask: torch.Tensor         # bool foreground
    binary: torch.Tensor       # bool ridges
    skeleton: torch.Tensor     # bool 1-px skeleton
    orientation: torch.Tensor  # [-pi/2, pi/2) pixel field
    reliability: torch.Tensor  # [0,1] upsampled block reliability


def exact_float32() -> None:
    """Keep float32 convolutions and matmuls in full float32 on the card
    (cuDNN convolutions default to TF32, which would move thresholds)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """Round through the uint8 grid, staying float (a true division, so the
    card and the CPU land on the same float)."""
    return bin_to_unit(torch.round(torch.clamp(x, 0.0, 1.0) * 255.0))


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """Percentile stretch (0.5/99.5) + CLAHE clip 2.5 tile 8."""
    f = percentile_stretch(img, 0.5, 99.5)
    return clahe(_quantize_u8(f), clip_limit=2.5, grid=8)


def denoise_image(img: torch.Tensor) -> torch.Tensor:
    """NLM (h=10, template 7, search 21) + 3x3 Gaussian sigma 0.6."""
    d = nlm_denoise(img, h=10.0, template_window=7, search_window=21)
    return gaussian_blur_cv(d, ksize=3, sigma=0.6)


def segment_fingerprint(img: torch.Tensor, hull_directions: int = 90
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """CLAHE 2.0 -> 5x5 Gaussian -> Otsu -> polarity fix -> 15x15 ellipse
    close/open -> largest component -> convex hull. Returns
    (segmented_gray, hull_mask)."""
    stab = clahe(_quantize_u8(img), clip_limit=2.0, grid=8)
    blur = gaussian_blur_cv(stab, ksize=5, sigma=0.0)
    thr = otsu_threshold(blur)[..., None, None]
    mask = blur > thr

    # foreground should be the darker side (ridges are dark)
    mf = mask.to(torch.float32)
    mean_fg = (img * mf).sum(dim=(-2, -1)) / torch.clamp(
        mf.sum(dim=(-2, -1)), min=1.0)
    mean_bg = (img * (1 - mf)).sum(dim=(-2, -1)) / torch.clamp(
        (1 - mf).sum(dim=(-2, -1)), min=1.0)
    flip = (mean_fg > mean_bg)[..., None, None]
    mask = torch.where(flip, ~mask, mask)

    m = binary_close_open_packed(mask, 15, shape="ellipse")
    m = largest_component(m)
    hull = convex_hull_mask(m, n_directions=hull_directions)
    empty = ~m.any(dim=-1).any(dim=-1)[..., None, None]    # empty -> all-ones
    hull = hull | empty
    return img * hull.to(img.dtype), hull


def binarize(img: torch.Tensor) -> torch.Tensor:
    """Hybrid Sauvola + per-patch-Otsu binarization: CLAHE 2.5 -> Sauvola
    (window 25, k-map k*(1 - 0.5*std_n), k=0.25) -> per-32x32 Otsu
    OR-refinement (patch std gate 3/255) -> remove objects < 80 -> fill
    holes < 150 -> 3x3 ellipse open -> erode-marker geodesic reconstruction
    (``ops.cuda_binarize.binarize_fused_split``)."""
    img_eq = clahe(_quantize_u8(img), clip_limit=2.5, grid=8)
    return binarize_fused_split(img_eq, win=25, k=0.25)


def smooth_fingerprint_skeleton(binary: torch.Tensor, sigma: float = 1.4,
                                diffusion_iter: int = 3,
                                contrast_boost: float = 1.25,
                                threshold: float = 0.35) -> torch.Tensor:
    """Anisotropic (tangential) smoothing of the binary ridge map."""
    img = binary.to(torch.float32)
    gx, gy = sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy) + 1e-6
    nx, ny = gx / mag, gy / mag

    smoothed = img
    for _ in range(diffusion_iter):
        dx, dy = sobel(smoothed)
        smoothed = smoothed + sigma * (dx * ny - dy * nx)

    smoothed = gaussian_blur(smoothed, 0.6)
    smoothed = torch.clamp(smoothed * contrast_boost, 0.0, 1.0)
    return smoothed > threshold


def thinning_and_cleaning(binary_smooth: torch.Tensor,
                          reliability: torch.Tensor,
                          rel_thresh: float = 0.1) -> torch.Tensor:
    """Clean 64/80 (4-connected) -> mask by smoothed reliability -> thin ->
    prune isolated pixels (thinning and prune in one kernel-C launch)."""
    rel_smooth = gaussian_blur(reliability, 2.0)
    mask = clean_mask(binary_smooth, 64, 80, connectivity=1)
    mask = mask & (rel_smooth > rel_thresh)
    return zs_thin(mask, 128, prune=True)


def gabor_stage(segmented: torch.Tensor, mask: torch.Tensor,
                orientation: torch.Tensor,
                gabor_params: dict | None = None) -> torch.Tensor:
    """The ``gabor=True`` branch: block ridge-frequency map -> the
    orientation/frequency Gabor bank -> [0, 1] by each image's largest
    response -> the segmented grey outside the mask. Returns the image
    binarize runs on."""
    gp = gabor_params or {}
    freq_map = estimate_ridge_frequency_blockwise(
        segmented, mask=mask, block_size=gp.get("block_size", 32))
    resp = gabor_enhance_blockfreq(
        segmented, orientation, freq_map, mask=mask,
        n_orientations=gp.get("n_orientations", 12),
        n_frequencies=gp.get("n_frequencies", 4),
        size=gp.get("kernel_size", 11))
    # map back to [0,1] with ridges dark (ridge centres correlate
    # negatively with the even cos kernel on dark-ridge images)
    amp = resp.abs().amax(dim=(-2, -1), keepdim=True)
    out = torch.clamp(0.5 + 0.5 * resp / torch.clamp(amp, min=1e-6), 0.0, 1.0)
    return torch.where(mask, out, segmented)


@traced("enhance")
def preprocess_fingerprint(img: torch.Tensor,
                           block_size: int = 16,
                           orientation_sigma: float = 3.0,
                           hull_directions: int = 90,
                           gabor: bool = False,
                           gabor_params: dict | None = None
                           ) -> EnhancementResult:
    """Full enhancement chain over (..., H, W) float32 in [0,1] on the
    input's device. H, W must be multiples of 32.

    gabor=True inserts the Gabor enhancement stage (``ops/gabor.py``):
    after the orientation field, a per-block ridge-frequency estimate
    drives an orientation/frequency-quantized Gabor bank, and binarization
    runs on the enhanced image. Config key: preprocessing.gabor.*.

    Spans, under ``enhance``, one a stage: ``enhance.normalize``,
    ``.denoise``, ``.segment``, ``.orientation``, ``.gabor`` (when on),
    ``.binarize``, ``.smooth``, ``.thin``.
    """
    exact_float32()
    with span("enhance.normalize"):
        normalized = normalize_image(img)
    with span("enhance.denoise"):
        denoised = denoise_image(normalized)
    with span("enhance.segment"):
        segmented, mask = segment_fingerprint(denoised, hull_directions)
    with span("enhance.orientation"):
        field: OrientationField = compute_orientation_field(
            segmented, mask=mask, block_size=block_size,
            smooth_sigma=orientation_sigma,
            smooth_orientation_sigma=orientation_sigma,
        )
    to_binarize = segmented
    if gabor:
        with span("enhance.gabor"):
            to_binarize = gabor_stage(segmented, mask, field.orientation,
                                      gabor_params)
    with span("enhance.binarize"):
        binary = binarize(to_binarize)
    with span("enhance.smooth"):
        binary_smooth = smooth_fingerprint_skeleton(binary.to(torch.float32))
    with span("enhance.thin"):
        skeleton = thinning_and_cleaning(binary_smooth, field.reliability)

    return EnhancementResult(
        normalized=normalized,
        denoised=denoised,
        segmented=segmented,
        mask=mask,
        binary=binary,
        skeleton=skeleton,
        orientation=field.orientation,
        reliability=field.reliability,
    )
