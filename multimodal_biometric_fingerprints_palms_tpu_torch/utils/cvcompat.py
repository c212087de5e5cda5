"""numpy counterparts of the OpenCV calls the SSL front, its training and
the segmentation make (the port imports no OpenCV):

- ``resize(img, (w, h), interpolation)`` for ``cv2.INTER_AREA`` and
  ``cv2.INTER_LINEAR`` on uint8 and float32 grey images. OpenCV's three
  area paths are kept apart: an integer ratio on both axes averages whole
  cells (``resizeAreaFast``); a shrink on both axes with a fractional ratio
  sums cell fractions in float32 (``resizeArea_``, its ``computeResizeArea
  Tab`` weights); an axis that grows sends both axes through the linear
  resampler with "area mode" coordinates. uint8 rounds back to uint8,
  OpenCV's way on each path (half to even from float; the fixed-point
  linear path in 11-bit coefficients). ``cv2.INTER_NEAREST`` takes source
  index ``floor(d / scale)`` (``scale = dst / src`` in float64). A 3-channel
  image is resized channel by channel (equal to OpenCV's, tested).
- ``blur(img, k)``: ``cv2.blur`` with ``BORDER_REFLECT_101``: the running
  row and column sums in float64 and the float64 scale ``1 / k**2``, as
  OpenCV's box filter keeps them for float32 input.
- ``rotation_matrix_2d``: ``cv2.getRotationMatrix2D``.
- ``warp_affine_linear``: ``cv2.warpAffine(..., INTER_LINEAR,
  BORDER_REFLECT_101)`` on float32 of 1 or 3 channels as OpenCV 4.11 and
  later compute it: float32 source coordinates (earlier versions cut them
  to 1/32 pixel in fixed point and took the weights from a table), formed
  one way in the vector loop and another in its scalar tail, and fused
  lerps.
- ``warp_affine_nearest``: ``cv2.warpAffine(..., INTER_NEAREST)`` with the
  default constant-0 border: the same float32 coordinates, rounded half to
  even.

``tests/test_torch_classifier.py`` and ``tests/test_torch_seg_train.py``
hold each to OpenCV and state what differs.
"""

from __future__ import annotations

import functools
import math

import numpy as np

INTER_NEAREST, INTER_LINEAR, INTER_AREA = 0, 1, 3   # cv2's constants
_COEF_BITS = 11                            # INTER_RESIZE_COEF_BITS


def _round_u8(x: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>`` of float: nearest, half to even, clamped."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _reflect101(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's ``borderInterpolate(p, n, BORDER_REFLECT_101)``: a
    reflection without repeating the edge, periodic in 2 (n - 1)."""
    p = np.asarray(p, np.int64)
    if n == 1:
        return np.zeros_like(p)
    q = p % (2 * n - 2)
    return np.where(q >= n, 2 * n - 2 - q, q)


# --- resize -------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _area_tab(ssize: int, dsize: int, scale: float) -> tuple:
    """``computeResizeAreaTab``: per destination index, its (source index,
    float32 weight) terms in OpenCV's order (cached by shape: one run sees
    a few)."""
    terms = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        t = []
        if sx1 - fsx1 > 1e-3:
            t.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            t.append((sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            t.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
        terms.append(tuple(t))
    return tuple(terms)


def _weighted_terms(src: np.ndarray, terms, axis: int) -> np.ndarray:
    """out[d] = sum over d's terms, in order, of src[s] * w (float32, one
    rounding a product and a sum): the terms are taken slot by slot for all
    destinations at once."""
    src = np.moveaxis(src, axis, 0)
    out = np.zeros((len(terms),) + src.shape[1:], np.float32)
    for slot in range(max(len(t) for t in terms)):
        dst = [d for d, t in enumerate(terms) if len(t) > slot]
        idx = [terms[d][slot][0] for d in dst]
        w = np.asarray([terms[d][slot][1] for d in dst], np.float32)
        w = w.reshape((-1,) + (1,) * (src.ndim - 1))
        if slot == 0:
            out[dst] = src[idx] * w
        else:
            out[dst] = out[dst] + src[idx] * w
    return np.moveaxis(out, 0, axis)


def _resize_area_frac(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``resizeArea_``: each source row's horizontal sum ``buf`` (float32,
    terms in order), then each destination row ``sum = beta0 * buf0 +
    beta1 * buf1 + ...``."""
    sh, sw = img.shape
    src = img.astype(np.float32)
    buf = _weighted_terms(src, _area_tab(sw, w, sw / w), axis=1)
    out = _weighted_terms(buf, _area_tab(sh, h, sh / h), axis=0)
    return _round_u8(out) if img.dtype == np.uint8 else out


def _resize_area_int(img: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """``resizeAreaFast``: integer cells, summed (in int for uint8, in
    OpenCV's order for float32) and scaled by the float32 ``1 / area``. For
    uint8 at 2 x 2 OpenCV's vector path rounds ``(sum + 2) >> 2``."""
    sh, sw = img.shape
    h, w = sh // sy, sw // sx
    cells = img[:h * sy, :w * sx].reshape(h, sy, w, sx)
    if img.dtype == np.uint8:
        total = cells.astype(np.int64).sum(axis=(1, 3))
        if (sx, sy) == (2, 2):
            return ((total + 2) >> 2).astype(np.uint8)
        return _round_u8(total.astype(np.float32)
                         * np.float32(1.0 / np.float32(sx * sy)))
    # float: at 2 x 2 OpenCV's vector path sums each row's pair, then the
    # rows; otherwise the cell's pixels in row order, four at a time
    terms = [cells[:, a, :, b].astype(np.float32)
             for a in range(sy) for b in range(sx)]
    area = sx * sy
    if (sx, sy) == (2, 2):
        return ((terms[0] + terms[1]) + (terms[2] + terms[3])) * np.float32(0.25)
    total = np.zeros((h, w), np.float32)
    k = 0
    while k <= area - 4:
        total = total + (((terms[k] + terms[k + 1]) + terms[k + 2])
                         + terms[k + 3])
        k += 4
    for t in terms[k:]:
        total = total + t
    return total * np.float32(np.float32(1.0) / np.float32(area))


def _linear_coeffs(ssize: int, dsize: int, area_mode: bool):
    """``resizeGeneric``'s (source index, weight of the next pixel) per
    destination index, clamped at the borders."""
    inv = dsize / ssize
    scale = 1.0 / inv
    idx = np.empty(dsize, np.int64)
    frac = np.empty(dsize, np.float32)
    for d in range(dsize):
        if area_mode:
            s = math.floor(d * scale)
            f = np.float32((d + 1) - (s + 1) * inv)
            f = np.float32(0.0) if f <= 0 else np.float32(f - math.floor(f))
        else:
            f = (d + 0.5) * scale - 0.5
            s = math.floor(f)
            f = np.float32(f - s)
        if s < 0:
            s, f = 0, np.float32(0.0)
        if s >= ssize - 1:
            s, f = ssize - 1, np.float32(0.0)
        idx[d], frac[d] = s, f
    return idx, frac


def _resize_linear(img: np.ndarray, w: int, h: int, area_mode: bool):
    sh, sw = img.shape
    xi, xf = _linear_coeffs(sw, w, area_mode)
    yi, yf = _linear_coeffs(sh, h, area_mode)
    x1 = np.minimum(xi + 1, sw - 1)
    y1 = np.minimum(yi + 1, sh - 1)
    if img.dtype == np.uint8:
        # fixed point: 11-bit coefficients, the vertical pass as OpenCV's
        # VResizeLinear<uchar> rounds it
        scale = 1 << _COEF_BITS
        ax0 = np.round((np.float32(1.0) - xf) * scale).astype(np.int64)
        ax1 = np.round(xf * scale).astype(np.int64)
        by0 = np.round((np.float32(1.0) - yf) * scale).astype(np.int64)
        by1 = np.round(yf * scale).astype(np.int64)
        s = img.astype(np.int64)
        rows = s[:, xi] * ax0 + s[:, x1] * ax1
        r0, r1 = rows[yi], rows[y1]
        out = (((by0[:, None] * (r0 >> 4)) >> 16)
               + ((by1[:, None] * (r1 >> 4)) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    by0 = (np.float32(1.0) - yf)[:, None]
    if area_mode:
        # float, an INTER_AREA axis that grows: in each pass both products
        # rounded to float32, then their sum (bit-equal to OpenCV)
        s = img.astype(np.float32)
        rows = s[:, xi] * (np.float32(1.0) - xf) + s[:, x1] * xf
        return rows[yi] * by0 + rows[y1] * yf[:, None]
    # float INTER_LINEAR: each pass's two products and their sum rounded
    # once to float32 (OpenCV's vector code rounds some of them once more:
    # within 2 ulps, tests/test_torch_classifier.py)
    s = img.astype(np.float64)
    rows = (s[:, xi] * (np.float32(1.0) - xf) + s[:, x1] * xf).astype(np.float32)
    r = rows.astype(np.float64)
    return (r[yi] * by0 + r[y1] * yf[:, None]).astype(np.float32)


def _resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))), sh - 1)
    return img[ys.astype(np.int64)][:, xs.astype(np.int64)]


def resize(img: np.ndarray, dsize: tuple[int, int],
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=...)`` of a uint8 or float32
    image of 1 or 3 channels ((H, W) or (H, W, 3)); ``dsize`` is (width,
    height) as in OpenCV."""
    if img.dtype not in (np.uint8, np.float32) or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise TypeError("resize takes a uint8 or float32 (H, W) or "
                        "(H, W, 3) image")
    w, h = dsize
    sh, sw = img.shape[:2]
    if (w, h) == (sw, sh):
        return img.copy()
    if interpolation == INTER_NEAREST:
        return _resize_nearest(img, w, h)
    if img.ndim == 3:
        return np.stack([resize(np.ascontiguousarray(img[..., c]), dsize,
                                interpolation) for c in range(3)], axis=2)
    if interpolation == INTER_AREA and sw >= w and sh >= h:
        if sw % w == 0 and sh % h == 0:
            return _resize_area_int(img, sw // w, sh // h)
        return _resize_area_frac(img, w, h)
    if interpolation not in (INTER_AREA, INTER_LINEAR):
        raise ValueError(f"interpolation {interpolation} is not ported")
    return _resize_linear(img, w, h, area_mode=interpolation == INTER_AREA)


# --- box filter ------------------------------------------------------------------

def _running_sums(x: np.ndarray, k: int, axis: int) -> np.ndarray:
    """OpenCV's running box sums along ``axis`` of a border-padded float64
    array: the first window summed term by term, then ``s += x[i + k] -
    x[i]``."""
    x = np.moveaxis(x, axis, 0)
    n = x.shape[0] - k + 1
    out = np.empty((n,) + x.shape[1:], np.float64)
    s = np.zeros(x.shape[1:], np.float64)
    for i in range(k):
        s = s + x[i]
    out[0] = s
    for i in range(n - 1):
        s = s + (x[i + k] - x[i])
        out[i + 1] = s
    return np.moveaxis(out, 0, axis)


def blur(img: np.ndarray, ksize: tuple[int, int]) -> np.ndarray:
    """``cv2.blur(img, ksize)`` (normalized box, centred anchor,
    ``BORDER_REFLECT_101``) of a 2-D float32 image."""
    if img.dtype != np.float32 or img.ndim != 2:
        raise TypeError("blur takes a 2-D float32 image")
    kw, kh = ksize
    h, w = img.shape
    rows = _reflect101(np.arange(-(kh // 2), h + kh - 1 - kh // 2), h)
    cols = _reflect101(np.arange(-(kw // 2), w + kw - 1 - kw // 2), w)
    padded = img.astype(np.float64)[rows][:, cols]
    row_sums = _running_sums(padded, kw, axis=1)
    # the column pass: SUM holds k - 1 rows; each output row is
    # (SUM + row) * scale, then SUM = that sum - the row leaving
    total = np.zeros(row_sums.shape[1], np.float64)
    for i in range(kh - 1):
        total = total + row_sums[i]
    scale = np.float64(1.0 / (kw * kh))
    out = np.empty((h, w), np.float32)
    for y in range(h):
        s = total + row_sums[y + kh - 1]
        out[y] = (s * scale).astype(np.float32)
        total = s - row_sums[y]
    return out


# --- rotation -------------------------------------------------------------------

def rotation_matrix_2d(center: tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64;
    the centre is a float32 point in OpenCV."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product of two float32 is
    exact in float64; the sum's float64 rounding can differ from a true
    fused multiply-add only on an exact float32 midpoint)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


_WARP_LANES = 16      # pixels a step of OpenCV's vector loop in warpAffine


def _warp_coords(M: np.ndarray, w: int, h: int):
    """Float32 source coordinates of every destination pixel, as OpenCV
    4.11+ forms them: in the vector loop ``fma(M0, x, M1 * y + M2)``; in
    the scalar tail (the last ``w % 16`` columns) ``fma(M0, x, M1 * y) +
    M2``."""
    Mf = M.astype(np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    tail = xs >= (w // _WARP_LANES) * _WARP_LANES

    def one(a, b, c):
        vec = _fma(a, xs, b * ys + c)
        scalar = _fma(a, xs, b * ys) + c
        return np.where(tail, scalar, vec)

    return one(Mf[0], Mf[1], Mf[2]), one(Mf[3], Mf[4], Mf[5])


def _inverse_affine(m: np.ndarray) -> np.ndarray:
    """OpenCV's inversion of a (2, 3) map, in float64."""
    M = np.asarray(m, np.float64).reshape(6).copy()
    d = M[0] * M[4] - M[1] * M[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = M[4] * d, M[0] * d
    M[0] = a11
    M[1] *= -d
    M[3] *= -d
    M[4] = a22
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return M


def warp_affine_linear(img: np.ndarray, m: np.ndarray,
                       dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_REFLECT_101)`` of a float32 image of 1 or 3
    channels ((H, W) or (H, W, 3)), as OpenCV 4.11 and later compute it:
    the inverse map in float64, then float32; the source coordinates of
    ``_warp_coords``; weights ``s - floor(s)``; and three fused lerps,
    along x on both rows, then along y."""
    if img.dtype != np.float32 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise TypeError("warp_affine_linear takes a float32 (H, W) or "
                        "(H, W, 3) image")
    w, h = dsize
    sh, sw = img.shape[:2]
    sx, sy = _warp_coords(_inverse_affine(m), w, h)
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = sx - fx, sy - fy
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    x0, x1 = _reflect101(ix, sw), _reflect101(ix + 1, sw)
    y0, y1 = _reflect101(iy, sh), _reflect101(iy + 1, sh)
    p00, p01 = img[y0, x0], img[y0, x1]
    p10, p11 = img[y1, x0], img[y1, x1]
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    return _fma(ay, bottom - top, top)


def warp_affine_nearest(img: np.ndarray, m: np.ndarray,
                        dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=INTER_NEAREST)`` of a 2-D
    image with OpenCV's default border, constant 0: the source pixel
    nearest ``_warp_coords``' float32 point (half to even), 0 outside."""
    if img.ndim != 2:
        raise TypeError("warp_affine_nearest takes a 2-D image")
    w, h = dsize
    sh, sw = img.shape
    sx, sy = _warp_coords(_inverse_affine(m), w, h)
    x, y = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
    inside = (x >= 0) & (x < sw) & (y >= 0) & (y < sh)
    got = img[np.clip(y, 0, sh - 1), np.clip(x, 0, sw - 1)]
    return np.where(inside, got, np.zeros((), img.dtype)).astype(img.dtype)


# --- drawing ------------------------------------------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
# OpenCV's drawing.cpp tables for anti-aliased lines
_SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192,
               194, 196, 198, 201, 203, 206, 209, 211, 214, 218, 221, 224,
               227, 231, 235, 238, 242, 246, 250, 254)
_FILTER = (168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249,
           252, 254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218,
           210, 202, 194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105,
           97, 89, 82, 75, 68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19,
           16, 14, 12, 11, 9, 8, 7, 5, 5)


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, p1: list, p2: list) -> bool:
    """OpenCV's ``clipLine`` on a (w, h) box (fixed-point coordinates):
    moves the end points onto the box; False when the line misses it."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def line_aa(img: np.ndarray, pt1, pt2, color) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, 1, cv2.LINE_AA)`` in place on an
    (H, W) or (H, W, C) uint8 image (C of 1, 3 or 4; ``color`` one value a
    channel): OpenCV's ``LineAA``, its 16-bit fixed point, slope
    correction, end-point and filter tables, and each pixel blended twice
    toward the colour by ``(c - v) * a + 127 >> 8``."""
    px = img if img.ndim == 3 else img[..., None]
    h, w, nch = px.shape
    col = [int(c) for c in (color if np.ndim(color) else [color])][:nch]
    col += [0] * (nch - len(col))
    p1 = [int(pt1[0]) << _XY_SHIFT, int(pt1[1]) << _XY_SHIFT]
    p2 = [int(pt2[0]) << _XY_SHIFT, int(pt2[1]) << _XY_SHIFT]
    if not _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2):
        return img
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            p1, p2 = p2, p1
        x_step = _XY_ONE
        y_step = _cdiv(dy << _XY_SHIFT, ax | 1)
        p2[0] += _XY_ONE
        ecount = (p2[0] >> _XY_SHIFT) - (p1[0] >> _XY_SHIFT)
        jj = -(p1[0] & (_XY_ONE - 1))
        p1[1] += ((y_step * jj) >> _XY_SHIFT) + (_XY_ONE >> 1)
        slope = (y_step >> (_XY_SHIFT - 5)) & 0x3F
        slope ^= 0x3F if y_step < 0 else 0
        ii = (p1[0] >> (_XY_SHIFT - 7)) & 0x78
        jj = (p2[0] >> (_XY_SHIFT - 7)) & 0x78
    else:
        dx = (dx ^ i) - i
        if i:
            p1, p2 = p2, p1
        x_step = _cdiv(dx << _XY_SHIFT, ay | 1)
        y_step = _XY_ONE
        p2[1] += _XY_ONE
        ecount = (p2[1] >> _XY_SHIFT) - (p1[1] >> _XY_SHIFT)
        jj = -(p1[1] & (_XY_ONE - 1))
        p1[0] += ((x_step * jj) >> _XY_SHIFT) + (_XY_ONE >> 1)
        slope = (x_step >> (_XY_SHIFT - 5)) & 0x3F
        slope ^= 0x3F if x_step < 0 else 0
        ii = (p1[1] >> (_XY_SHIFT - 7)) & 0x78
        jj = (p2[1] >> (_XY_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
    t0 = slope << 7
    t1 = ((0x78 - ii) | 4) * slope
    t2 = (jj | 4) * slope
    ep = [0] * 9
    ep[8] = slope
    ep[1] = ep[3] = ((((jj - ii) & 0x78) | 4) * slope >> 8) & 0x1FF
    ep[2] = (t1 >> 8) & 0x1FF
    ep[4] = ((((jj - ii) + 0x80) | 4) * slope >> 8) & 0x1FF
    ep[5] = ((t1 + t0) >> 8) & 0x1FF
    ep[6] = (t2 >> 8) & 0x1FF
    ep[7] = ((t2 + t0) >> 8) & 0x1FF

    def put(x, y, a):
        for c in range(nch):
            v = int(px[y, x, c])
            v += ((col[c] - v) * a + 127) >> 8
            v += ((col[c] - v) * a + 127) >> 8
            px[y, x, c] = v

    major, minor = (0, 1) if ax > ay else (1, 0)
    lim_major, lim_minor = (w, h) if ax > ay else (h, w)
    m = p1[major] >> _XY_SHIFT
    pos = p1[minor]
    step = y_step if ax > ay else x_step
    scount = 0
    while ecount >= 0:
        if 0 <= m < lim_major:
            n = (pos >> _XY_SHIFT) - 1
            corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3
                      + (((ecount >= 2) + 1) & (ecount | 2))]
            dist = (pos >> (_XY_SHIFT - 5)) & 31
            for k, f in ((0, _FILTER[dist + 32]), (1, _FILTER[dist]),
                         (2, _FILTER[63 - dist])):
                if 0 <= n + k < lim_minor:
                    a = (corr * f >> 8) & 0xFF
                    if ax > ay:
                        put(m, n + k, a)
                    else:
                        put(n + k, m, a)
        m += 1
        pos += step
        scount += 1
        ecount -= 1
    return img


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float) -> np.ndarray:
    """``cv2.addWeighted`` of two uint8 arrays: ``a * alpha + (b * beta +
    gamma)`` in float32 with OpenCV's weights as float32, rounded half to
    even and saturated. (At 0.8 and 0.2, the weights the visualisation
    uses, this and OpenCV's vector and scalar loops agree on all 65,536
    pairs of values: no product lands on a rounding tie.)"""
    al, be, ga = (np.float64(np.float32(v)) for v in (alpha, beta, gamma))
    inner = (np.asarray(b, np.float64) * be + ga).astype(np.float32)
    out = (np.asarray(a, np.float64) * al + inner).astype(np.float32)
    return _round_u8(out)
