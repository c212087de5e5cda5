"""Image ops of the port. Plain PyTorch, except the CUDA kernels: CLAHE
(``cuda_kernels``), connected components (``cuda_cc``), Zhang-Suen thinning
(``cuda_thin``), non-local means (``cuda_nlm``, twin in ``denoise``), the
binarize front (``cuda_binarize``) and its open/erode/reconstruct tail
(``cuda_morph``), each beside its plain twin. The Gabor bank (``gabor``)
is plain PyTorch (one cuDNN convolution on the card)."""

from .filters import (
    conv2d_same, gaussian_kernel1d, gaussian_blur, gaussian_blur_cv,
    box_filter, blur_mean, sobel,
)
from .histogram import (
    histogram256, quantiles_bisect, quantiles_u8, percentile_stretch,
    otsu_threshold, otsu_threshold_patchwise, clahe, equalize_hist,
)
from .denoise import (
    nlm_denoise, nlm_denoise_blocked, nlm_denoise_sym, bilateral_filter,
)
from .cuda_binarize import (
    binarize_foreground, binarize_fused, binarize_fused_split,
    fill_holes_phase2, sauvola_binarize,
)
from .cuda_morph import open_erode_reconstruct
from .morphology import (
    ellipse_se, erode, dilate, opening, closing, reconstruction_by_dilation,
    binary_dilate, binary_erode, binary_opening, binary_closing,
    binary_close_open_packed, binary_reconstruction_by_dilation,
)
from .components import (
    connected_components, component_sizes, remove_small_objects,
    remove_small_holes, clean_mask, largest_component, convex_hull_mask,
    mask_bbox,
)
from .skeleton import (
    neighbor_count, skeletonize, prune_isolated, prune_endpoints,
)
from .orientation import compute_orientation_field, OrientationField
from .geometry import (
    rotate_points, angle_diff, orientation_diff, resize_bilinear, affine_warp,
)
from .gabor import (
    gabor_kernel, gabor_enhance, estimate_ridge_frequency_blockwise,
    gabor_enhance_blockfreq, estimate_ridge_frequency,
)
