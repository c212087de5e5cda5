"""ROC plot of the port (FAR against FRR), drawn as a plain numpy raster
and written as a PNG through the port's codec (the card's machine has no
matplotlib). The same input draws the same pixels on every machine; the
file is an artifact, and its pixels are not matplotlib's.

The picture: a white canvas, a frame around the unit square (FAR to the
right, FRR up), a light grid at tenths, the EER diagonal FRR = FAR in
grey, and the curve through the points sorted by FAR, with a dot at each.
``title`` is kept for the JAX package's signature; no text is drawn.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.io import write_image

_SIZE = 400          # plot square, pixels
_MARGIN = 40
# BGR, as the codec takes colour
_FRAME = (0, 0, 0)
_GRID = (225, 225, 225)
_DIAGONAL = (150, 150, 150)
_CURVE = (180, 119, 31)


def _to_px(far, frr):
    x = _MARGIN + np.clip(far, 0.0, 1.0) * (_SIZE - 1)
    y = _MARGIN + (1.0 - np.clip(frr, 0.0, 1.0)) * (_SIZE - 1)
    return np.round(x).astype(int), np.round(y).astype(int)


def _polyline(canvas, xs, ys, color, width=1, dash=0):
    """Segments between consecutive points, sampled a pixel apart."""
    for (x0, y0, x1, y1) in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        n = max(abs(x1 - x0), abs(y1 - y0)) + 1
        t = np.linspace(0.0, 1.0, n)
        px = np.round(x0 + (x1 - x0) * t).astype(int)
        py = np.round(y0 + (y1 - y0) * t).astype(int)
        if dash:
            keep = (np.arange(n) // dash) % 2 == 0
            px, py = px[keep], py[keep]
        for d in range(width):
            canvas[np.clip(py + d, 0, canvas.shape[0] - 1), px] = color


def plot_roc(far, frr, out_path: str | Path = "logs/roc.png",
             title: str = "ROC (FAR vs FRR)"):
    far = np.asarray(far, dtype=np.float64)
    frr = np.asarray(frr, dtype=np.float64)
    order = np.argsort(far, kind="stable")
    side = _SIZE + 2 * _MARGIN
    canvas = np.full((side, side, 3), 255, np.uint8)
    lo, hi = _MARGIN, _MARGIN + _SIZE - 1
    for t in np.linspace(0.0, 1.0, 11)[1:-1]:
        gx, gy = _to_px(np.array([t, t]), np.array([0.0, 1.0]))
        _polyline(canvas, gx, gy, _GRID)
        gx, gy = _to_px(np.array([0.0, 1.0]), np.array([t, t]))
        _polyline(canvas, gx, gy, _GRID)
    dx, dy = _to_px(np.array([0.0, 1.0]), np.array([0.0, 1.0]))
    _polyline(canvas, dx, dy, _DIAGONAL, dash=6)
    _polyline(canvas, np.array([lo, hi, hi, lo, lo]),
              np.array([lo, lo, hi, hi, lo]), _FRAME)
    if far.size:
        xs, ys = _to_px(far[order], frr[order])
        _polyline(canvas, xs, ys, _CURVE, width=2)
        for dy_ in (-1, 0, 1):
            for dx_ in (-1, 0, 1):
                canvas[np.clip(ys + dy_, 0, side - 1),
                       np.clip(xs + dx_, 0, side - 1)] = _CURVE
    out_path = Path(out_path)
    write_image(out_path, canvas)
    return out_path
