"""Orientation field overlay of the port (the JAX package's
``preprocessing/visualize.py``): a line per block, gated by the mask and
the reliability, blended over the grey image, RGB out.

A debug figure, drawn on the host in numpy as the JAX module draws it
with OpenCV: ``utils/cvcompat.line_aa`` (``cv2.line`` with ``LINE_AA``)
and ``add_weighted`` (``cv2.addWeighted``), both equal to OpenCV's pixels.
Tensors are moved to the host; arrays are taken as they are.
"""

from __future__ import annotations

import numpy as np

from ..utils.cvcompat import add_weighted, line_aa


def _host(x):
    if x is None:
        return None
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def visualize_orientation(img, orient_img, reliability_img=None,
                          block_size: int = 16, scale: int = 8,
                          rel_thresh: float = 0.2, mask=None,
                          color=(255, 0, 0)) -> np.ndarray:
    """Returns an RGB uint8 overlay. img in [0,1] or uint8."""
    g = _host(img)
    orient_img = _host(orient_img)
    reliability_img = _host(reliability_img)
    mask = _host(mask)
    if g.dtype != np.uint8:
        g = np.clip(g * 255.0 if g.max() <= 1.0 + 1e-6 else g, 0, 255)
        g = g.astype(np.uint8)
    base = np.repeat(g[..., None], 3, axis=2)
    vis = base.copy()
    bgr = tuple(color[::-1])

    h, w = orient_img.shape
    half = block_size // 2
    for by in range(h // block_size):
        for bx in range(w // block_size):
            cy = by * block_size + half
            cx = bx * block_size + half
            if cy >= h or cx >= w:
                continue
            if mask is not None and not mask[cy, cx]:
                continue
            if (reliability_img is not None
                    and reliability_img[cy, cx] < rel_thresh):
                continue
            angle = float(orient_img[cy, cx])
            dx = int(round(scale * np.cos(angle)))
            dy = int(round(scale * np.sin(angle)))
            x1, y1 = max(0, cx - dx), max(0, cy - dy)
            x2, y2 = min(w - 1, cx + dx), min(h - 1, cy + dy)
            line_aa(vis, (x1, y1), (x2, y2), bgr)

    overlay = add_weighted(vis, 0.8, base, 0.2, 0)
    return np.ascontiguousarray(overlay[..., ::-1])
