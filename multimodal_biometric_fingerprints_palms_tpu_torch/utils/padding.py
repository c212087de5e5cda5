"""Static-shape helpers of the port (a copy of the JAX package's
``utils/padding.py``): every image of a run is padded to one canonical
(H, W), so a batch is one tensor, and carries a validity mask."""

from __future__ import annotations

import numpy as np


def pad_to_multiple(x: np.ndarray, multiple: int, fill: float = 0.0) -> np.ndarray:
    """Pad the trailing two dims of ``x`` up to a multiple of ``multiple``."""
    h, w = x.shape[-2], x.shape[-1]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(x, pad, constant_values=fill)


def canonical_shape(shapes, multiple: int = 8) -> tuple[int, int]:
    """Smallest (H, W), each a multiple of ``multiple``, covering all shapes."""
    h = max(s[0] for s in shapes)
    w = max(s[1] for s in shapes)
    h += (-h) % multiple
    w += (-w) % multiple
    return h, w


def pad_image_batch(images, shape: tuple[int, int], fill: float = 0.0):
    """Stack variably-sized 2-D arrays into a (B, H, W) batch plus masks.

    Returns (batch, mask) where mask marks valid (un-padded) pixels.
    """
    b = len(images)
    h, w = shape
    batch = np.full((b, h, w), fill, dtype=np.float32)
    mask = np.zeros((b, h, w), dtype=bool)
    for i, img in enumerate(images):
        ih, iw = img.shape[:2]
        if ih > h or iw > w:
            raise ValueError(f"image {i} shape {img.shape} exceeds canonical {shape}")
        batch[i, :ih, :iw] = img
        mask[i, :ih, :iw] = True
    return batch, mask
