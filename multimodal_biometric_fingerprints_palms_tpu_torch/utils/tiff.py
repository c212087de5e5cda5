"""TIFF for the port's codec, in numpy and ``zlib``: what OpenCV's TIFF
reader (libtiff's RGBA interface) and writer do.

Read: the first directory of a file of either byte order, in strips or
tiles; compression none (1), LZW (5), Deflate (8 and 32946) and PackBits
(32773), each with predictor 1 or 2; 1, 2, 4, 8 and 16 bits a sample;
MinIsWhite, MinIsBlack, RGB (chunky or planar), RGB with an alpha sample
and palette images. Samples become 8-bit RGB as libtiff's
``TIFFReadRGBA*`` makes them (the grey ramp ``v * 255 // max``, inverted
for MinIsWhite, the high byte of a 16-bit grey sample, ``(v + 128) //
257`` of a 16-bit colour one, a palette's 16-bit entries by their high
byte unless every entry is below 256, colour times an unassociated alpha);
grey is then OpenCV's rounding 14-bit weights. The orientation tag (274)
is returned for the caller to apply. Anything else (JPEG-in-TIFF, CCITT
and other compressions, float or signed samples, YCbCr, CMYK and Lab)
raises ``ImageFormatError`` naming what it is.

Write: an (H, W) grey or (H, W, 3) BGR uint8 array as ``cv2.imwrite``
writes it: LZW with the horizontal predictor, strips of ``8192 // row
bytes`` rows, colour as RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .codec_base import ImageFormatError

TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*")

_COMPRESSION_NAMES = {
    2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style "
    "JPEG", 7: "JPEG", 34712: "JPEG 2000", 32809: "ThunderScan",
    34676: "SGI LogLuv", 34677: "SGI LogLuv", 32908: "PixarFilm",
    32909: "PixarLog", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP",
    50002: "JPEG XL", 34887: "LERC", 9: "JBIG", 10: "JBIG2"}
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 16: ("Q", 8)}


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
        tags[tag] = struct.unpack(bo + fmt * count, raw)
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


def _samples(data: bytes, tags: dict, bo: str, name: str) -> np.ndarray:
    """(H, W, samples per pixel) integer samples of the first image."""
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = tags.get(258, (1,))[0]
    comp = tags.get(259, (1,))[0]
    planar = tags.get(284, (1,))[0]
    predictor = tags.get(317, (1,))[0]
    if comp not in (1, 5, 8, 32946, 32773):
        what = _COMPRESSION_NAMES.get(comp, f"compression {comp}")
        raise _error(name, f"TIFF with {what} compression is not supported")
    if tags.get(339, (1,))[0] != 1:
        raise _error(name, "TIFF with float or signed samples is not "
                     "supported")
    if bits not in (1, 2, 4, 8, 16) or any(b != bits for b in tags.get(
            258, (1,))):
        raise _error(name, f"TIFF with {tags.get(258)} bits a sample is not "
                     "supported")
    if comp in (1, 32773):
        predictor = 1               # libtiff's codecs for these ignore it
    if predictor not in (1, 2) or (predictor == 2 and bits < 8):
        raise _error(name, f"TIFF predictor {predictor} with {bits}-bit "
                     "samples is not supported")
    if tags.get(266, (1,))[0] != 1:
        raise _error(name, "TIFF with LSB-first bit order is not supported")
    decode = {1: lambda b, n: b[:n], 5: _lzw_decode, 8: _inflate,
              32946: _inflate, 32773: _packbits_decode}[comp]
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
                need = rows * -(-(tw * pspp * bits) // 8)
                blob = data[offsets[k]:offsets[k] + counts[k]]
                if len(blob) < counts[k]:
                    raise _error(name, "truncated TIFF data")
                raw = decode(blob, need)
                if len(raw) < need:
                    raise _error(name, "TIFF strip or tile decodes short")
                s = _chunk_samples(raw, rows, tw, pspp, bits, bo, predictor)
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


# what remains of an orientation once its left-right mirror is done
_AFTER_MIRROR = {2: 1, 3: 4, 6: 7, 7: 6}


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
