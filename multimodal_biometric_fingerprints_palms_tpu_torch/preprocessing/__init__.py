"""The enhancement chain of the port."""

from .enhance import (
    EnhancementResult, binarize, denoise_image, normalize_image,
    preprocess_fingerprint, segment_fingerprint, smooth_fingerprint_skeleton,
    thinning_and_cleaning,
)
