"""TIFF for the port's codec, in numpy and ``zlib``: what OpenCV's TIFF
reader (libtiff's RGBA interface) and writer do.

Read: the first directory of a file of either byte order, in strips or
tiles; compression none (1), LZW (5), Deflate (8 and 32946), PackBits
(32773), CCITT RLE, Group 3 and Group 4 (2, 3, 4: ``ccitt.py``) and JPEG
(7: each strip an abbreviated stream after the ``JPEGTables`` tag, decoded
by the codec's JPEG decoder, YCbCr made RGB by it as libjpeg does for
libtiff); predictor 1 or 2; fill order 1 or 2 (each byte of a strip
reversed first, as libtiff does for every codec but JPEG); 1, 2, 4, 8 and
16 bits a sample, unsigned or signed (read as unsigned, as the RGBA reader
does); MinIsWhite, MinIsBlack, RGB (chunky or planar), RGB with an alpha
sample, palette, YCbCr (any subsampling libtiff's reader has a routine
for), CMYK and CIELab. Samples become 8-bit RGB as libtiff's
``TIFFReadRGBA*`` makes them (the grey ramp ``v * 255 // max``, inverted
for MinIsWhite, the high byte of a 16-bit grey sample, ``(v + 128) //
257`` of a 16-bit colour one, a palette's 16-bit entries by their high
byte unless every entry is below 256, colour times an unassociated alpha,
``TIFFYCbCrToRGB``'s tables, ``(255 - k) * (255 - c) // 255`` for CMYK,
``TIFFCIELab16ToXYZ`` and ``TIFFXYZToRGB`` on the sRGB display in
float32); grey is then OpenCV's rounding 14-bit weights. The orientation
tag (274) is returned for the caller to apply. Anything else (RLEW,
old-style JPEG and the other compressions, float samples, 16-bit YCbCr,
CMYK and CIELab) raises ``ImageFormatError`` naming what it is.

Write: an (H, W) grey or (H, W, 3) BGR uint8 array as ``cv2.imwrite``
writes it: LZW with the horizontal predictor, strips of ``8192 // row
bytes`` rows, colour as RGB.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib

import numpy as np

from .ccitt import decode_ccitt
from .codec_base import ImageFormatError

TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*")

_COMPRESSION_NAMES = {
    6: "old-style JPEG", 34712: "JPEG 2000", 32809: "ThunderScan",
    32771: "RLEW (word-aligned CCITT RLE)",
    34676: "SGI LogLuv", 34677: "SGI LogLuv", 32908: "PixarFilm",
    32909: "PixarLog", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP",
    50002: "JPEG XL", 34887: "LERC", 9: "JBIG", 10: "JBIG2"}
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 16: ("Q", 8)}
_CCITT = (2, 3, 4)
# the YCbCr subsamplings libtiff's RGBA reader has a routine for
_YCBCR_BLOCKS = ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
_READ = (1, 5, 7, 8, 32946, 32773) + _CCITT
# bits of each byte in the other order, for a fill order of 2
_REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def _error(name: str, what: str):
    return ImageFormatError(f"{name}: {what}")


def _tags(data: bytes, name: str) -> tuple[dict, str]:
    """The first directory's tags: {tag: tuple of values}."""
    bo = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise _error(name, "truncated TIFF")
    at = struct.unpack(bo + "I", data[4:8])[0]
    if at < 8 or at + 2 > len(data):
        raise _error(name, "TIFF without a valid first directory")
    n = struct.unpack(bo + "H", data[at:at + 2])[0]
    if n == 0 or at + 2 + 12 * n > len(data):
        raise _error(name, "TIFF with a truncated directory")
    tags = {}
    for k in range(n):
        e = at + 2 + 12 * k
        tag, kind, count = struct.unpack(bo + "HHI", data[e:e + 8])
        if kind not in _TYPES:
            continue
        fmt, size = _TYPES[kind]
        nbytes = size * count
        if nbytes <= 4:
            raw = data[e + 8:e + 8 + nbytes]
        else:
            off = struct.unpack(bo + "I", data[e + 8:e + 12])[0]
            raw = data[off:off + nbytes]
            if len(raw) < nbytes:
                raise _error(name, f"TIFF tag {tag} past the end of the file")
        vals = struct.unpack(bo + fmt * count, raw)
        if kind in (5, 10):             # rationals, as libtiff's floats
            vals = tuple(float(np.float32(n) / np.float32(d)) if d else 0.0
                         for n, d in zip(vals[::2], vals[1::2]))
        tags[tag] = vals
    return tags, bo


def _lzw_decode(data: bytes, need: int) -> bytes:
    """TIFF LZW: MSB-first codes of 9 to 12 bits, the width growing one
    code early, clear (256) and end (257) codes; stops at ``need`` bytes."""
    if data[:2] == b"\x00\x01":
            raise ImageFormatError("old-style (LSB-first) LZW is not supported")
    buf = data + b"\x00\x00\x00"
    nbits_total = 8 * len(data)
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, pos, prev = 9, 0, None
    while pos + nbits <= nbits_total and len(out) < need:
        i = pos >> 3
        word = buf[i] << 16 | buf[i + 1] << 8 | buf[i + 2]
        code = (word >> (24 - nbits - (pos & 7))) & ((1 << nbits) - 1)
        pos += nbits
        if code == 256:
            del table[258:]
            nbits, prev = 9, None
            continue
        if code == 257:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(table[prev] + entry[:1])
        elif prev is not None and code == len(table):
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            break                               # a corrupt code: stop here
        out += entry
        prev = code
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


def _packbits_decode(data: bytes, need: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < need:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _inflate(data: bytes, need: int) -> bytes:
    try:
        return zlib.decompressobj().decompress(data, need)
    except zlib.error:
            raise ImageFormatError("corrupt Deflate data in TIFF") from None


def _chunk_samples(raw: bytes, rows: int, width: int, spp: int, bits: int,
                   bo: str, predictor: int) -> np.ndarray:
    """(rows, width, spp) integer samples of one strip or tile."""
    if bits == 16:
        need = rows * width * spp * 2
        raw = raw.ljust(need, b"\x00")[:need]
        s = np.frombuffer(raw, bo + "u2").astype(np.int64).reshape(
            rows, width * spp)
    else:
        stride = -(-(width * spp * bits) // 8)
        raw = raw.ljust(rows * stride, b"\x00")[:rows * stride]
        b = np.frombuffer(raw, np.uint8).reshape(rows, stride)
        if bits == 8:
            s = b[:, :width * spp].astype(np.int64)
        else:
            per = 8 // bits
            shifts = np.arange(per - 1, -1, -1) * bits
            s = ((b.astype(np.int64)[..., None] >> shifts)
                 & ((1 << bits) - 1)).reshape(rows, -1)[:, :width * spp]
    if predictor == 2:
        s = np.cumsum(s.reshape(rows, width, spp), axis=1).reshape(
            rows, width * spp) & ((1 << bits) - 1)
    return s.reshape(rows, width, spp)


def _jpeg_chunk(blob: bytes, tables: bytes, rows: int, width: int, ycc: bool,
                sampling: tuple, name: str) -> np.ndarray:
    """(rows, width, samples) of a JPEG-compressed strip or tile: an
    abbreviated stream after the ``JPEGTables`` (tag 347) tables, decoded
    by the codec's own JPEG decoder with the colour handling of libtiff's
    ``tif_jpeg.c`` under the RGBA reader: YCbCr converted to RGB by libjpeg
    (``JPEGCOLORMODE_RGB``), anything else as coded."""
    from .image_codec import decode_jpeg_samples     # imports this module
    if tables[-2:] == b"\xff\xd9" and blob[:2] == b"\xff\xd8":
        blob = tables[:-2] + blob[2:]
    px, comps = decode_jpeg_samples(blob, name, ycc)
    if px.shape[:2] != (rows, width):
        raise _error(name, f"TIFF JPEG strip or tile of {px.shape[0]}x"
                     f"{px.shape[1]}, not {rows}x{width}")
    if ycc and tuple(comps[0][1:3]) != sampling:
        raise _error(name, f"TIFF JPEG sampling {comps[0][1:3]}, not the "
                     f"YCbCrSubsampling tag's {sampling}")
    if not ycc and any(c[1:3] != (1, 1) for c in comps):
        raise _error(name, "TIFF JPEG with subsampled components other than "
                     "YCbCr is not supported")
    return px.astype(np.int64)


def _ycbcr_units(raw: bytes, rows: int, width: int, hs: int,
                 vs: int) -> np.ndarray:
    """(rows, width, 3) Y, Cb, Cr of subsampled YCbCr data units (hs * vs
    luma samples, then Cb and Cr), each chroma pair on its whole block, as
    libtiff's ``putcontig8bitYCbCr*tile`` apply it."""
    across, down = -(-width // hs), -(-rows // vs)
    unit = hs * vs + 2
    need = across * down * unit
    u = np.frombuffer(raw.ljust(need, b"\x00")[:need], np.uint8).reshape(
        down, across, unit).astype(np.int64)
    y = u[..., :hs * vs].reshape(down, across, vs, hs).transpose(
        0, 2, 1, 3).reshape(down * vs, across * hs)
    cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)
    return np.stack([y, cb, cr], axis=-1)[:rows, :width]


def _samples(data: bytes, tags: dict, bo: str, name: str) -> np.ndarray:
    """(H, W, samples per pixel) integer samples of the first image; a
    YCbCr image in JPEG strips comes back as RGB."""
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))[0]
    comp = tags.get(259, (1,))[0]
    planar = tags.get(284, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    photometric = tags.get(262, (None,))[0]
    if comp not in _READ:
        what = _COMPRESSION_NAMES.get(comp, f"compression {comp}")
        raise _error(name, f"TIFF with {what} compression is not supported")
    if tags.get(339, (1,))[0] not in (1, 2):
        # signed integers read as unsigned, as libtiff's RGBA reader does
        raise _error(name, "TIFF with float samples is not supported")
    if bits not in (1, 2, 4, 8, 16) or any(b != bits for b in tags.get(
            258, (1,))):
        raise _error(name, f"TIFF with {tags.get(258)} bits a sample is not "
                     "supported")
    if comp in _CCITT and (bits, spp) != (1, 1):
        raise _error(name, f"CCITT TIFF with {spp} samples of {bits} bits")
    if comp == 7 and (bits != 8 or planar != 1):
        raise _error(name, "TIFF JPEG other than 8-bit and chunky is not "
                     "supported")
    if comp in (1, 32773) + _CCITT + (7,):
        predictor = 1               # libtiff's codecs for these ignore it
    if predictor not in (1, 2) or (predictor == 2 and bits < 8):
        raise _error(name, f"TIFF predictor {predictor} with {bits}-bit "
                     "samples is not supported")
    fill = tags.get(266, (1,))[0]
    if fill not in (1, 2):
        raise _error(name, f"TIFF fill order {fill}")
    sub = (1, 1)
    if photometric == 6:
        sub = tuple(tags.get(530, (2, 2))[:2])
        if comp != 7 and sub != (1, 1) and (
                planar != 1 or bits != 8 or spp != 3 or predictor != 1
                or sub not in _YCBCR_BLOCKS):
            raise _error(name, f"TIFF YCbCr subsampled {sub} is not "
                         "supported in this layout")
    tables = bytes(tags.get(347, ()))
    tiled = 322 in tags
    if tiled:
        tw, th = tags[322][0], tags[323][0]
        offsets, counts = tags.get(324), tags.get(325)
    else:
        tw, th = w, min(tags.get(278, (h,))[0], h) or h
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None:
        raise _error(name, "TIFF without image data offsets")
    planes = spp if planar == 2 else 1
    pspp = 1 if planar == 2 else spp
    across, down = -(-w // tw), -(-h // th)
    if len(offsets) < planes * across * down:
        raise _error(name, "TIFF with too few strips or tiles")
    out = np.zeros((down * th, across * tw, spp), np.int64)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = th if tiled else min(th, h - ty * th)
                blob = data[offsets[k]:offsets[k] + counts[k]]
                if len(blob) < counts[k]:
                    raise _error(name, "truncated TIFF data")
                if fill == 2 and comp != 7:     # libjpeg reads it as is
                    blob = blob.translate(_REVERSED)
                if comp == 7:
                    s = _jpeg_chunk(blob, tables, rows, tw, photometric == 6,
                                    sub, name)
                elif sub != (1, 1):
                    hs, vs = sub
                    need = -(-tw // hs) * -(-rows // vs) * (hs * vs + 2)
                    raw = _DECODE[comp](blob, need)
                    if len(raw) < need:
                        raise _error(name, "TIFF strip or tile decodes short")
                    s = _ycbcr_units(raw, rows, tw, hs, vs)
                else:
                    need = rows * -(-(tw * pspp * bits) // 8)
                    if comp in _CCITT:
                        try:
                            raw = decode_ccitt(blob, comp, tw, rows,
                                               tags.get(292, (0,))[0])
                        except ImageFormatError as e:
                            raise _error(name, str(e)) from None
                    else:
                        raw = _DECODE[comp](blob, need)
                    if len(raw) < need:
                        raise _error(name, "TIFF strip or tile decodes short")
                    s = _chunk_samples(raw, rows, tw, pspp, bits, bo,
                                       predictor)
                ch = slice(p, p + 1) if planar == 2 else slice(None)
                out[ty * th:ty * th + rows, tx * tw:(tx + 1) * tw, ch] = s
                k += 1
    out = out[:h, :w]
    orientation = tags.get(274, (0,))[0]
    if orientation in (2, 3, 6, 7):
        # libtiff's RGBA reader mirrors each strip or tile it reads within
        # its own width; OpenCV then applies the orientation's other part
        for x in range(0, w, tw):
            out[:, x:x + tw] = out[:, x:x + tw][:, ::-1]
    return out


_DECODE = {1: lambda b, n: b[:n], 5: _lzw_decode, 8: _inflate,
           32946: _inflate, 32773: _packbits_decode}


# what remains of an orientation once its left-right mirror is done
_AFTER_MIRROR = {2: 1, 3: 4, 6: 7, 7: 6}


def _float_tag(tags: dict, tag: int, default: tuple) -> np.ndarray:
    vals = tags.get(tag, default)
    if len(vals) < len(default):
        vals = default
    return np.asarray(vals[:len(default)], np.float32)


def _fix(x) -> int:
    """libtiff's ``FIX``: ``(int32_t)(x * (1L << 16) + 0.5)`` on a float."""
    return int(np.float64(np.float32(x) * np.float32(65536)) + 0.5)


def _ycbcr_rgb(s: np.ndarray, tags: dict) -> np.ndarray:
    """libtiff's ``TIFFYCbCrToRGBInit`` tables and ``TIFFYCbCrtoRGB``, in
    float32 where libtiff computes in float: the coefficients of tag 529
    (0.299, 0.587, 0.114 without it), ``ReferenceBlackWhite`` of tag 532
    (0, 255, 128, 255, 128, 255 without it)."""
    f = np.float32
    lr, lg, lb = _float_tag(tags, 529, (0.299, 0.587, 0.114))
    rbw = _float_tag(tags, 532, (0, 255, 128, 255, 128, 255))
    f1 = f(2) - f(2) * lr
    f3 = f(2) - f(2) * lb
    d1 = _fix(np.clip(f1, 0, 2))
    d2 = -_fix(np.clip(lr * f1 / lg, 0, 2))
    d3 = _fix(np.clip(f3, 0, 2))
    d4 = -_fix(np.clip(lb * f3 / lg, 0, 2))
    x = np.arange(-128, 128)

    def code2v(c, rb, rw, cr):
        den = f(rw - rb) if rw != rb else f(1)
        v = ((c - int(rb)).astype(np.float32) * f(cr)) / den
        return np.clip(v, -128 * 32, 128 * 32).astype(np.int64)
    cr = code2v(x, rbw[4] - f(128), rbw[5] - f(128), 127)
    cb = code2v(x, rbw[2] - f(128), rbw[3] - f(128), 127)
    y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    y, cb_i, cr_i = s[..., 0], s[..., 1], s[..., 2]
    yv = y_tab[y]
    r = yv + ((d1 * cr[cr_i] + (1 << 15)) >> 16)
    g = yv + ((d4 * cb[cb_i] + (1 << 15) + d2 * cr[cr_i]) >> 16)
    b = yv + ((d3 * cb[cb_i] + (1 << 15)) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255)


# sRGB display of libtiff's tif_getimage.c (``display_sRGB``)
_SRGB = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                  [0.0556, -0.2040, 1.0570]], np.float32)
_LAB_RANGE = 1500


@functools.lru_cache(maxsize=1)
def _lab_gamma_table() -> np.ndarray:
    """``Yr2r``: ``255 * (float)pow(i / 1500.0, 1.0 / 2.4F)``, by the C
    library's ``pow`` as libtiff takes it (numpy's may use a vector
    ``pow`` that is not correctly rounded)."""
    gamma = 1.0 / float(np.float32(2.4))
    return np.float32(255) * np.array(
        [math.pow(i / _LAB_RANGE, gamma) for i in range(_LAB_RANGE + 1)],
        np.float64).astype(np.float32)


def _lab_rgb(s: np.ndarray, tags: dict) -> np.ndarray:
    """libtiff's ``initCIELabConversion``, ``TIFFCIELab16ToXYZ`` and
    ``TIFFXYZToRGB`` on 8-bit L and signed a, b, in float32 in libtiff's
    order: the white point of tag 318 (D50 without it), the sRGB display's
    matrix and its table of 1,501 gamma-2.4 steps."""
    f = np.float32
    d50 = f(96.4250) + f(100.0) + f(82.4680)
    wp = _float_tag(tags, 318, (f(96.4250) / d50, f(100.0) / d50))
    if wp[1] == 0:
        raise ImageFormatError("TIFF CIELab white point with Y of 0")
    x0 = wp[0] / wp[1] * f(100)
    y0 = f(100)
    z0 = (f(1) - wp[0] - wp[1]) / wp[1] * f(100)
    big_l = (s[..., 0] * 257).astype(np.float32) * f(100) / f(65535)
    a = ((s[..., 1] ^ 128) - 128) * 256
    b = ((s[..., 2] ^ 128) - 128) * 256
    small = big_l < f(8.856)
    y_small = (big_l * y0) / f(903.292)
    cby = np.where(small, f(7.787) * (y_small / y0) + f(16) / f(116),
                   (big_l + f(16)) / f(116)).astype(np.float32)
    yy = np.where(small, y_small, y0 * cby * cby * cby).astype(np.float32)

    def cube(t, ref):
        return np.where(t < f(0.2069), ref * (t - f(0.13793)) / f(7.787),
                        ref * t * t * t).astype(np.float32)
    xx = cube(a.astype(np.float32) / f(256) / f(500) + cby, x0)
    zz = cube(cby - b.astype(np.float32) / f(256) / f(200), z0)
    step = (f(100) - f(1)) / f(_LAB_RANGE)
    table = _lab_gamma_table()
    out = []
    for row in _SRGB:
        lum = row[0] * xx + row[1] * yy + row[2] * zz
        lum = np.minimum(np.maximum(lum, f(1)), f(100))
        i = np.minimum(((lum - f(1)) / step).astype(np.int64), _LAB_RANGE)
        v = table[i].astype(np.float64)
        out.append(np.minimum(np.where(v > 0, v + 0.5, v - 0.5).astype(
            np.int64), 255))
    return np.stack(out, axis=-1)


def decode_tiff(data: bytes, name: str = "<bytes>"):
    """(8-bit RGB (H, W, 3) as libtiff's RGBA reader gives it, the
    orientation left for the caller to apply: the tag's value, less the
    left-right mirror that the read already made (strip by strip, or tile
    by tile, so a tiled file's mirror is not the whole image's))."""
    if data[:4] not in TIFF_SIGNATURES:
        raise _error(name, "not a TIFF file")
    tags, bo = _tags(data, name)
    for t in (256, 257):
        if t not in tags or tags[t][0] == 0:
            raise _error(name, "TIFF without an image size")
    photometric = tags.get(262, (None,))[0]
    s = _samples(data, tags, bo, name)
    bits = tags.get(258, (1,))[0]
    spp = s.shape[2]
    extra = tags.get(338, ())
    if photometric == 6 and tags.get(259, (1,))[0] == 7:
        photometric = 2             # libjpeg made it RGB
    if photometric in (5, 6, 8) and (bits != 8 or tags.get(
            284, (1,))[0] != 1):
        raise _error(name, f"TIFF with photometric interpretation "
                     f"{photometric} other than 8-bit and chunky is not "
                     "supported")
    if photometric in (0, 1):
        rng = 255 if bits == 16 else (1 << bits) - 1
        v = s[..., 0] >> 8 if bits == 16 else s[..., 0]
        v = (rng - v) * 255 // rng if photometric == 0 else v * 255 // rng
        rgb = np.repeat(v[..., None], 3, axis=2)
    elif photometric == 2 and spp >= 3:
        rgb = (s[..., :3] + 128) // 257 if bits == 16 else s[..., :3]
        if spp >= 4 and extra and extra[0] == 2:        # unassociated alpha
            a = (s[..., 3] + 128) // 257 if bits == 16 else s[..., 3]
            rgb = (rgb * a[..., None] + 127) // 255
    elif photometric == 3 and spp == 1 and 320 in tags:
        n = 1 << bits
        cmap = np.asarray(tags[320], np.int64)
        if cmap.size < 3 * n:
            raise _error(name, "TIFF colour map too short")
        cmap = cmap[:3 * n].reshape(3, n).T
        if (cmap >= 256).any():
            cmap = cmap >> 8
        rgb = cmap[s[..., 0]]
    elif photometric == 5 and spp >= 4 and tags.get(332, (1,))[0] == 1:
        k = 255 - s[..., 3:4]           # putRGBcontig8bitCMYKtile
        rgb = k * (255 - s[..., :3]) // 255
    elif photometric == 6 and spp == 3:
        rgb = _ycbcr_rgb(s, tags)
    elif photometric == 8 and spp == 3:
        try:
            rgb = _lab_rgb(s, tags)
        except ImageFormatError as e:
            raise _error(name, str(e)) from None
    else:
        raise _error(name, f"TIFF with photometric interpretation "
                     f"{photometric} and {spp} samples is not supported")
    orientation = tags.get(274, (0,))[0]
    return rgb.astype(np.uint8), _AFTER_MIRROR.get(orientation, orientation)


# --- write ------------------------------------------------------------------

def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it without its ratio-driven resets:
    a clear code first, codes MSB first, the width growing when the next
    code no longer fits, a clear code when the table is full, an end code
    last."""
    out = bytearray()
    acc = nacc = 0
    width = 9
    table = {}
    nxt = 258
    codes = [256]
    widths = [9]
    cur = -1
    for b in data:
        if cur < 0:
            cur = b
            continue
        key = cur << 8 | b
        hit = table.get(key)
        if hit is not None:
            cur = hit
            continue
        codes.append(cur)
        widths.append(width)
        table[key] = nxt
        nxt += 1
        if nxt == 4094:
            codes.append(256)
            widths.append(width)
            table = {}
            nxt, width = 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        cur = b
    if cur >= 0:
        codes.append(cur)
        widths.append(width)
        nxt += 1
        if nxt == 4094:
            codes.append(256)
            widths.append(width)
            width = 9
        elif nxt > (1 << width) - 1:
            width += 1
    codes.append(257)
    widths.append(width)
    for code, n in zip(codes, widths):
        acc = (acc << n) | code
        nacc += n
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def encode_tiff(img: np.ndarray) -> bytes:
    """A little-endian TIFF of an (H, W) grey or (H, W, 3) BGR uint8 array:
    LZW, horizontal predictor, strips of ``max(1, 8192 // row bytes)``
    rows, as ``cv2.imwrite`` writes by default."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ImageFormatError(
            f"TIFF encode takes (H, W) or (H, W, 3) uint8, not "
            f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ImageFormatError(f"TIFF cannot hold a {h}x{w} image")
    spp = 1 if img.ndim == 2 else 3
    px = (img if spp == 1 else img[..., ::-1]).reshape(h, w * spp)
    rps = max(1, min(h, 8192 // (w * spp)))
    diff = px.astype(np.int64)
    diff[:, spp:] -= px[:, :-spp]
    diff = (diff & 0xFF).astype(np.uint8)
    strips = [_lzw_encode(diff[y:y + rps].tobytes()) for y in range(0, h, rps)]
    data = b"".join(strips)
    offsets = np.cumsum([8] + [len(s) for s in strips])[:-1].tolist()
    short = 3 if max(w, h) < 1 << 16 else 4      # libtiff's choice
    entries = [(256, short, [w]), (257, short, [h]), (258, 3, [8] * spp),
               (259, 3, [5]), (262, 3, [1 if spp == 1 else 2]),
               (273, 4, offsets), (277, 3, [spp]), (278, short, [rps]),
               (279, 4, [len(s) for s in strips]), (284, 3, [1]),
               (317, 3, [2]), (339, 3, [1] * spp)]
    at = 8 + len(data) + (len(data) & 1)         # the directory on a word
    spill_at = at + 2 + 12 * len(entries) + 4
    # values too long for their entry follow the directory, in tag order
    # but for the strip offsets, which libtiff writes after the counts
    raws = {tag: struct.pack("<" + {3: "H", 4: "I"}[kind] * len(vals), *vals)
            for tag, kind, vals in entries}
    where, spill = {}, b""
    for tag in sorted(raws, key=lambda t: 279.5 if t == 273 else t):
        if len(raws[tag]) > 4:
            where[tag] = spill_at + len(spill)
            spill += raws[tag]
    ifd = struct.pack("<H", len(entries))
    for tag, kind, vals in entries:
        if tag in where:
            ifd += struct.pack("<HHII", tag, kind, len(vals), where[tag])
        else:
            ifd += struct.pack("<HHI", tag, kind, len(vals)) + raws[tag].ljust(
                4, b"\x00")
    return (b"II*\x00" + struct.pack("<I", at) + data + b"\x00" * (at - 8 - len(data))
            + ifd + struct.pack("<I", 0) + spill)
