"""Skeletonization (port of ``ops/skeleton.py``): Zhang-Suen thinning,
which runs kernel C (``ops.cuda_thin``) on CUDA tensors."""

from __future__ import annotations

import numpy as np
import torch

from .cuda_thin import prune_isolated_plain, zs_thin
from .filters import conv2d_same

_NEIGHBOR_KERNEL = np.array([[1.0, 1.0, 1.0],
                             [1.0, 0.0, 1.0],
                             [1.0, 1.0, 1.0]], dtype=np.float32)


def neighbor_count(skel: torch.Tensor) -> torch.Tensor:
    """Count of 8-neighbours (float32)."""
    return conv2d_same(skel.to(torch.float32), _NEIGHBOR_KERNEL, border="zero")


def skeletonize(mask: torch.Tensor, max_iters: int = 128) -> torch.Tensor:
    """Zhang-Suen thinning to a 1-px-wide skeleton; mask: bool (..., H, W)."""
    return zs_thin(mask, max_iters)


def prune_isolated(skel: torch.Tensor) -> torch.Tensor:
    """Drop skeleton pixels with no 8-neighbours."""
    return prune_isolated_plain(skel)
