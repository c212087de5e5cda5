"""Skeletonization (port of ``ops/skeleton.py``): Zhang-Suen thinning,
which runs kernel C (``ops.cuda_thin``) on CUDA tensors; the 8-neighbour
count, the prune of isolated pixels and ``prune_endpoints``, the spur
trim, in plain PyTorch."""

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


def prune_endpoints(skel: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Iteratively remove endpoints (neighbour count == 1) to shorten spurs."""
    s = skel.to(torch.bool)
    for _ in range(iterations):
        s = s & (neighbor_count(s) != 1.0)
    return s
