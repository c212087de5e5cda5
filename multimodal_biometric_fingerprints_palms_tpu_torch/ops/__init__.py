"""Image ops of the port. Plain PyTorch, except the three CUDA kernels:
CLAHE (``cuda_kernels``), connected components (``cuda_cc``) and
Zhang-Suen thinning (``cuda_thin``), each beside its plain twin."""

from .filters import (
    conv2d_same, gaussian_kernel1d, gaussian_blur, gaussian_blur_cv,
    box_filter, blur_mean, sobel,
)
from .histogram import (
    histogram256, quantiles_bisect, quantiles_u8, percentile_stretch,
    otsu_threshold, otsu_threshold_patchwise, clahe,
)
from .denoise import nlm_denoise
from .morphology import (
    ellipse_se, binary_dilate, binary_erode, binary_opening, binary_closing,
    binary_close_open_packed, binary_reconstruction_by_dilation,
)
from .components import (
    connected_components, component_sizes, remove_small_objects,
    remove_small_holes, clean_mask, largest_component, convex_hull_mask,
    mask_bbox,
)
from .skeleton import neighbor_count, skeletonize, prune_isolated
from .orientation import compute_orientation_field, OrientationField
