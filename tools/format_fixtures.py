#!/usr/bin/env python3
"""Writes the image files the port's codec is held to OpenCV on:
``tests/fixtures/formats/``.

    python3 tools/format_fixtures.py [--out tests/fixtures/formats]

Every file is small (29 x 35 pixels and the like) and made with OpenCV, PIL
or the little writers below (PNG of every bit depth, palette and Adam7;
BMP of 1 to 32 bits, bit fields and RLE; TIFF in strips or tiles, any byte
order, compression, predictor and layout; Exif blocks). ``expected.json``
holds OpenCV's decode of each: ``cv2.imdecode`` with ``IMREAD_GRAYSCALE``
and with ``IMREAD_COLOR`` (then ``COLOR_BGR2RGB``), each as its shape and
the sha256 of its bytes, so a machine without OpenCV can hold the port to
it. ``tests/test_torch_formats.py`` derives the digests again from OpenCV.

``prints/`` holds the 320 x 240 files of the card's formats phase
(``chip_smoke.py``): the blob-constellation prints ``tools/polyu_set.py``
draws for subjects 1 to 4 (``FORMAT_SUBJECTS``), stored as a progressive
JPEG, a progressive colour JPEG (the print in all three channels, 4:2:0),
TIFF without compression, with Deflate and with PackBits, 16-bit,
palette and interlaced PNG, 32-bit and RLE8 BMP, and a PNG and a TIFF
whose pixels are stored turned and carry the orientation that turns them
back. Each JPEG has its baseline twin ``base_<name>.jpg``, the same print
at the same quality, whose pixels equal its own; each lossless file holds
the decode of a baseline JPEG of its print, so its pixels are ones the
all-baseline tree can hold too.

This script needs OpenCV and PIL; the port does not.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

H, W = 29, 35


def source(h=H, w=W, seed=0, channels=1) -> np.ndarray:
    """Smooth noise: every value in use, neighbours related."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (h + 4, w + 4, channels)).astype(np.float64)
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    for ax in (0, 1):
        x = np.apply_along_axis(lambda v: np.convolve(v, k, "valid"), ax, x)
    x = (x - x.min()) / max(x.max() - x.min(), 1) * 255
    x = np.round(x).astype(np.uint8)
    return x[..., 0] if channels == 1 else x


# --- Exif -------------------------------------------------------------------

def exif_block(orientation: int, bo: str = "<", ifd: int = 8, n=None,
               kind: int = 3) -> bytes:
    """A TIFF-structured Exif block whose IFD0 holds the orientation."""
    head = (b"II*\x00" if bo == "<" else b"MM\x00*") + struct.pack(bo + "I", ifd)
    pad = bytes(ifd - 8)
    body = struct.pack(bo + "H", 1 if n is None else n)
    value = (struct.pack(bo + "HH", orientation, 0) if kind == 3
             else struct.pack(bo + "I", orientation))
    body += struct.pack(bo + "HHI", 0x0112, kind, 1) + value
    return head + pad + body + struct.pack(bo + "I", 0)


def jpeg_with_app1(jpeg: bytes, payload: bytes) -> bytes:
    seg = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    return jpeg[:2] + seg + jpeg[2:]


# --- PNG --------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(rows: np.ndarray, bpp: int, first_filter: int) -> bytes:
    """PNG filtering, the filter type cycling 0..4 from row to row."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ft = (first_filter + y) % 5
        left = np.r_[np.zeros(bpp, np.int64), row[:-bpp]] if len(row) > bpp \
            else np.zeros_like(row)
        if len(row) <= bpp:
            left = np.zeros_like(row)
        upleft = np.r_[np.zeros(bpp, np.int64), prev[:-bpp]] \
            if len(row) > bpp else np.zeros_like(row)
        if ft == 0:
            f = row
        elif ft == 1:
            f = row - left
        elif ft == 2:
            f = row - prev
        elif ft == 3:
            f = row - ((left + prev) >> 1)
        else:
            f = row - np.array([_paeth(a, b, c) for a, b, c in
                                zip(left.tolist(), prev.tolist(),
                                    upleft.tolist())], np.int64)
        out.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w * channels) samples as PNG row bytes of ``depth`` bits."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    n = samples.shape[1]
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = samples
    g = padded.reshape(h, -1, per)
    shifts = np.arange(per - 1, -1, -1) * depth
    return (g << shifts).sum(-1).astype(np.uint8)


_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def png(samples: np.ndarray, depth: int, ctype: int, palette=None,
        trns: bytes | None = None, interlace: bool = False,
        exif: bytes | None = None, exif_after_idat: bool = False) -> bytes:
    """A PNG of (H, W) or (H, W, C) samples (C in PNG's order: RGB[A])."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w, c = s.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b""
        for i, (x0, y0, dx, dy) in enumerate(_ADAM7):
            sub = s[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _filter_rows(_pack_rows(sub.reshape(sub.shape[0], -1),
                                               depth), bpp, i)
    else:
        raw = _filter_rows(_pack_rows(s.reshape(h, -1), depth), bpp, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    if exif is not None and not exif_after_idat:
        out += _chunk(b"eXIf", exif)
    z = zlib.compress(raw, 9)
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    if exif is not None and exif_after_idat:
        out += _chunk(b"eXIf", exif)
    return out + _chunk(b"IEND", b"")


# --- BMP --------------------------------------------------------------------

def _rle8(rows: np.ndarray, delta: bool) -> bytes:
    out = bytearray()
    for y, row in enumerate(rows.tolist()):
        x = 0
        if delta and y == 2:                 # skip 3 pixels of the row
            out += bytes([0, 2, 3, 0])
            x = 3
        if delta and y == 4:                 # leave the row unwritten
            out += b"\x00\x00"
            continue
        while x < len(row):
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 2:
                out += bytes([run, row[x]])
                x += run
                continue
            lit = 1
            while (x + lit < len(row) and lit < 255
                   and (x + lit + 1 >= len(row)
                        or row[x + lit] != row[x + lit + 1])):
                lit += 1
            if lit >= 3:
                out += bytes([0, lit]) + bytes(row[x:x + lit])
                if lit % 2:
                    out += b"\x00"
            else:
                for v in row[x:x + lit]:
                    out += bytes([1, v])
            x += lit
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


def _rle4(rows: np.ndarray) -> bytes:
    out = bytearray()
    for row in rows.tolist():
        x = 0
        while x < len(row):
            if x + 1 < len(row) and row[x] == row[x + 1]:
                run = 2
                while x + run < len(row) and row[x + run] == row[x] and run < 255:
                    run += 1
                out += bytes([run, row[x] << 4 | row[x]])
                x += run
                continue
            lit = min(len(row) - x, 8 + (x % 5))
            if lit >= 3:
                vals = row[x:x + lit] + [0]
                packed = bytes(vals[i] << 4 | vals[i + 1]
                               for i in range(0, lit, 2))
                out += bytes([0, lit]) + packed
                if len(packed) % 2:
                    out += b"\x00"
            else:
                nxt = row[x + 1] if lit == 2 else 0
                out += bytes([lit, row[x] << 4 | nxt])
            x += lit
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


def bmp(px: np.ndarray, bpp: int, palette=None, compression: int = 0,
        top_down: bool = False, masks=None, delta: bool = False,
        os2: bool = False) -> bytes:
    """A BMP with a 40-byte header (plus masks for bit fields) of (H, W)
    indices or 16-bit words, or (H, W, 3|4) BGR[A]; with ``os2``, the
    12-byte OS/2 header (16-bit sizes, bottom-up rows, no compression) and
    a palette of 3-byte entries."""
    h, w = px.shape[:2]
    rows = px if top_down else px[::-1]
    if compression == 1:
        data = _rle8(rows, delta)
    elif compression == 2:
        data = _rle4(rows)
    else:
        if bpp < 8:
            packed = _pack_rows(rows.reshape(h, -1), bpp)
        elif bpp == 16:
            packed = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            packed = rows.reshape(h, -1).astype(np.uint8)
        stride = (packed.shape[1] + 3) & ~3
        buf = np.zeros((h, stride), np.uint8)
        buf[:, :packed.shape[1]] = packed
        data = buf.tobytes()
    pal = b"" if palette is None else b"".join(
        bytes([b, g, r] if os2 else [b, g, r, 0])
        for b, g, r in np.asarray(palette).tolist())
    if os2:
        offset = 14 + 12 + len(pal)
        head = b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
        return head + struct.pack("<IHHHH", 12, w, h, 1, bpp) + pal + data
    extra = b"" if masks is None else struct.pack("<III", *masks)
    offset = 14 + 40 + len(extra) + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       compression, len(data), 2835, 2835,
                       0 if palette is None else len(palette), 0)
    head = b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
    return head + info + extra + pal + data


# --- TIFF -------------------------------------------------------------------

def lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, early change)."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    cur = b""
    for b in data:
        cand = cur + bytes([b])
        if cand in table:
            cur = cand
            continue
        put(table[cur])
        table[cand] = nxt
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
        if nxt >= 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        cur = bytes([b])
    if cur:
        put(table[cur])
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and data[i + run] == data[i] and run < 128:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and (
                j + 1 >= len(data) or data[j] != data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_COMPRESS = {1: lambda b: b, 5: lzw, 8: lambda b: zlib.compress(b, 6),
             32946: lambda b: zlib.compress(b, 6), 32773: packbits}


def _predict(block: np.ndarray, bits: int, spp: int) -> np.ndarray:
    """Horizontal differencing of (rows, width * spp) samples."""
    b = block.astype(np.int64)
    d = b.copy()
    d[:, spp:] = b[:, spp:] - b[:, :-spp]
    return d & ((1 << bits) - 1)


def _sample_bytes(block: np.ndarray, bits: int, bo: str) -> bytes:
    rows = block.shape[0]
    if bits == 16:
        return block.astype(bo + "u2").tobytes()
    if bits == 8:
        return block.astype(np.uint8).tobytes()
    return _pack_rows(block.reshape(rows, -1), bits).tobytes()


def tiff(px: np.ndarray, bits: int = 8, photometric: int | None = None,
         compression: int = 1, predictor: int = 1, bo: str = "<",
         rows_per_strip: int | None = None, tile: tuple | None = None,
         planar: int = 1, colormap=None, extra_samples=None,
         orientation: int | None = None, pages: int = 1) -> bytes:
    """A TIFF of (H, W) or (H, W, C) samples (RGB[A] order)."""
    s = px if px.ndim == 3 else px[..., None]
    h, w, spp = s.shape
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    planes = [s] if planar == 1 else [s[..., c:c + 1] for c in range(spp)]
    pspp = spp if planar == 1 else 1
    chunks = []
    if tile is None:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                chunks.append(p[y:y + rps].reshape(-1, w * pspp))
    else:
        th, tw = tile
        for p in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, pspp), s.dtype)
                    part = p[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(t.reshape(th, tw * pspp))
    blobs = []
    for c in chunks:
        if predictor == 2:
            c = _predict(c, bits, pspp)
        blobs.append(_COMPRESS[compression](_sample_bytes(c, bits, bo)))

    def ifd(at: int, nxt: int, width: int, height: int) -> bytes:
        entries = []

        def tag(t, kind, vals):
            entries.append((t, kind, list(vals)))
        tag(256, 4, [width])
        tag(257, 4, [height])
        tag(258, 3, [bits] * spp)
        tag(259, 3, [compression])
        tag(262, 3, [photometric])
        if orientation is not None:
            tag(274, 3, [orientation])
        tag(277, 3, [spp])
        tag(284, 3, [planar])
        if predictor != 1:
            tag(317, 3, [predictor])
        if colormap is not None:
            tag(320, 3, np.asarray(colormap).T.reshape(-1).tolist())
        if extra_samples is not None:
            tag(338, 3, [extra_samples])
        offsets, counts, pos = [], [], 8
        for b in blobs:
            offsets.append(pos)
            counts.append(len(b))
            pos += len(b) + (len(b) & 1)
        if tile is None:
            tag(273, 4, offsets)
            tag(278, 4, [rows_per_strip or h])
            tag(279, 4, counts)
        else:
            tag(322, 4, [tile[1]])
            tag(323, 4, [tile[0]])
            tag(324, 4, offsets)
            tag(325, 4, counts)
        entries.sort()
        out = struct.pack(bo + "H", len(entries))
        spill, spill_at = b"", at + 2 + 12 * len(entries) + 4
        for t, kind, vals in entries:
            raw = struct.pack(bo + {3: "H", 4: "I"}[kind] * len(vals), *vals)
            if len(raw) <= 4:
                out += struct.pack(bo + "HHI", t, kind, len(vals)) + raw.ljust(
                    4, b"\x00")
            else:
                out += struct.pack(bo + "HHII", t, kind, len(vals),
                                   spill_at + len(spill))
                spill += raw + b"\x00" * (len(raw) & 1)
        return out + struct.pack(bo + "I", nxt) + spill

    data = b"".join(b + b"\x00" * (len(b) & 1) for b in blobs)
    head = (b"II*\x00" if bo == "<" else b"MM\x00*")
    at = 8 + len(data)
    out = head + struct.pack(bo + "I", at) + data
    first = ifd(at, 0, w, h)
    if pages == 1:
        return out + first
    # a second page over the same data at half the size: a reader that
    # took it would give another shape
    nxt = at + len(first)
    return out + ifd(at, nxt, w, h) + ifd(nxt, 0, w // 2, h // 2)


# --- the cases ---------------------------------------------------------------

def _cv(ext: str, img, params=()):
    import cv2
    ok, b = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return b.tobytes()


def _pil(img, fmt: str, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    (img if hasattr(img, "save") else Image.fromarray(img)).save(
        buf, fmt, **kw)
    return buf.getvalue()


def cases() -> dict[str, bytes]:
    """{file name: bytes} of every fixture file but the prints."""
    import cv2
    grey = source()
    rgb = source(seed=1, channels=3)
    big = source(64, 80, seed=2)
    out = {}

    # JPEG: Exif orientation in both byte orders, none, malformed blocks
    base = _cv(".jpg", grey)
    for bo, tag in (("<", "II"), (">", "MM")):
        for o in range(1, 9):
            out[f"jpeg_exif_{tag}_o{o}.jpg"] = jpeg_with_app1(
                base, b"Exif\x00\x00" + exif_block(o, bo))
    out["jpeg_exif_none.jpg"] = base
    bad = {
        "bad_byte_order": b"XX*\x00" + exif_block(6)[4:],
        "bad_magic": b"II+\x00" + exif_block(6)[4:],
        "ifd_out_of_block": exif_block(6, ifd=4000)[:26],
        "truncated": exif_block(6)[:10],
        "value_9": exif_block(9),
        "count_past_end": exif_block(6, n=40),
        "long_type": exif_block(6, kind=4),
    }
    for k, blk in bad.items():
        out[f"jpeg_exif_malformed_{k}.jpg"] = jpeg_with_app1(
            base, b"Exif\x00\x00" + blk)
    out["jpeg_exif_malformed_no_prefix.jpg"] = jpeg_with_app1(
        base, exif_block(6))
    out["jpeg_exif_colour_o6.jpg"] = jpeg_with_app1(
        _cv(".jpg", rgb[..., ::-1]), b"Exif\x00\x00" + exif_block(6))
    # progressive and colour JPEG, every sampling layout, restarts
    sampling = {s: getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + s)
                for s in ("444", "422", "420", "440", "411")}
    for s, v in sampling.items():
        for prog in (0, 1):
            for rst in (0, 2):
                name = (f"jpeg_{'progressive' if prog else 'baseline'}_{s}"
                        f"{'_rst' if rst else ''}.jpg")
                out[name] = _cv(".jpg", rgb[..., ::-1], [
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, v,
                    cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                    cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                    cv2.IMWRITE_JPEG_QUALITY, 90])
    out["jpeg_progressive_420_tiny.jpg"] = _cv(".jpg", rgb[:3, :5, ::-1], [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    out["jpeg_progressive_grey.jpg"] = _cv(
        ".jpg", big, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    out["jpeg_progressive_grey_rst.jpg"] = _cv(".jpg", big, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    out["jpeg_progressive_grey_q50.jpg"] = _cv(".jpg", big, [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 50])
    out["jpeg_progressive_pil.jpg"] = _pil(rgb, "JPEG", progressive=True,
                                           quality=80)

    # PNG: every bit depth and colour type, palette, tRNS, Adam7, eXIf
    for d in (1, 2, 4, 8, 16):
        v = (grey.astype(np.int64) * ((1 << d) - 1) + 127) // 255
        out[f"png_grey{d}.png"] = png(v, d, 0)
        out[f"png_grey{d}_adam7.png"] = png(v, d, 0, interlace=True)
    g16 = grey.astype(np.int64) * 257 + (source(seed=5).astype(np.int64) - 128)
    g16 = np.clip(g16, 0, 65535)
    r16 = np.clip(rgb.astype(np.int64) * 257
                  + source(seed=6, channels=3).astype(np.int64) - 128,
                  0, 65535)
    out["png_grey16_low_bits.png"] = png(g16, 16, 0)
    out["png_grey_alpha8.png"] = png(np.stack([grey, 255 - grey], -1), 8, 4)
    out["png_grey_alpha16.png"] = png(np.stack([g16, g16[::-1]], -1), 16, 4)
    out["png_rgb8.png"] = png(rgb, 8, 2)
    out["png_rgb16.png"] = png(r16, 16, 2)
    out["png_rgb16_adam7.png"] = png(r16, 16, 2, interlace=True)
    out["png_rgba8.png"] = png(np.concatenate([rgb, grey[..., None]], -1), 8, 6)
    out["png_rgba16.png"] = png(np.concatenate([r16, g16[..., None]], -1),
                                16, 6)
    out["png_rgb8_adam7.png"] = png(rgb, 8, 2, interlace=True)
    rng = np.random.default_rng(7)
    for d in (1, 2, 4, 8):
        n = 1 << d
        pal = rng.integers(0, 256, (n, 3))
        idx = (grey.astype(np.int64) * n) >> 8
        out[f"png_palette{d}.png"] = png(idx, d, 3, palette=pal)
    pal = rng.integers(0, 256, (16, 3))
    idx = (grey.astype(np.int64) * 16) >> 8
    out["png_palette4_adam7.png"] = png(idx, 4, 3, palette=pal, interlace=True)
    out["png_palette4_trns.png"] = png(idx, 4, 3, palette=pal,
                                       trns=bytes(range(0, 160, 10)))
    gpal = np.repeat(np.arange(0, 256, 17)[:, None], 3, 1)
    out["png_palette4_grey_entries.png"] = png(idx, 4, 3, palette=gpal)
    out["png_grey8_trns.png"] = png(grey, 8, 0, trns=struct.pack(">H", 100))
    out["png_grey16_trns.png"] = png(g16, 16, 0,
                                     trns=struct.pack(">H", int(g16[3, 3])))
    out["png_rgb8_trns.png"] = png(rgb, 8, 2, trns=struct.pack(
        ">HHH", *rgb[4, 4].tolist()))
    for o in range(1, 9):
        out[f"png_exif_o{o}.png"] = png(grey, 8, 0, exif=exif_block(o))
    out["png_exif_after_idat_o6.png"] = png(grey, 8, 0, exif=exif_block(6, ">"),
                                            exif_after_idat=True)
    out["png_exif_colour_adam7_o5.png"] = png(rgb, 8, 2, interlace=True,
                                              exif=exif_block(5))
    out["png_cv2_grey16.png"] = _cv(".png", g16.astype(np.uint16))
    out["png_cv2_colour16.png"] = _cv(".png", r16[..., ::-1].astype(np.uint16))
    out["png_pil_palette.png"] = _pil(
        __import__("PIL.Image", fromlist=["Image"]).fromarray(rgb).quantize(
            37), "PNG")

    # BMP: 1, 4, 8, 16, 24, 32 bits, bit fields, RLE, both row orders
    bgr = rgb[..., ::-1]
    for d in (1, 4, 8):
        n = 1 << d
        pal = rng.integers(0, 256, (n, 3))
        idx = (grey.astype(np.int64) * n) >> 8
        out[f"bmp{d}.bmp"] = bmp(idx, d, pal)
        out[f"bmp{d}_top_down.bmp"] = bmp(idx, d, pal, top_down=True)
    gp = np.repeat(np.arange(256)[:, None], 3, 1)
    out["bmp8_grey_palette.bmp"] = bmp(grey, 8, gp)
    pal = rng.integers(0, 256, (256, 3))
    runs = np.repeat(grey[:, ::3], 3, axis=1)[:, :W]
    out["bmp_rle8.bmp"] = bmp(runs, 8, pal, compression=1)
    out["bmp_rle8_delta.bmp"] = bmp(runs, 8, pal, compression=1, delta=True)
    out["bmp_rle8_top_down.bmp"] = bmp(runs, 8, pal, compression=1,
                                       top_down=True)
    pal16 = rng.integers(0, 256, (16, 3))
    runs4 = (runs.astype(np.int64) * 16) >> 8
    out["bmp_rle4.bmp"] = bmp(runs4, 4, pal16, compression=2)
    b5, g5, r5 = (bgr[..., c].astype(np.int64) >> 3 for c in range(3))
    out["bmp16_555.bmp"] = bmp(b5 | g5 << 5 | r5 << 10, 16)
    g6 = bgr[..., 1].astype(np.int64) >> 2
    out["bmp16_565_bitfields.bmp"] = bmp(b5 | g6 << 5 | r5 << 11, 16,
                                         compression=3,
                                         masks=(0xF800, 0x07E0, 0x001F))
    out["bmp16_555_bitfields.bmp"] = bmp(b5 | g5 << 5 | r5 << 10, 16,
                                         compression=3,
                                         masks=(0x7C00, 0x03E0, 0x001F))
    out["bmp24.bmp"] = bmp(bgr, 24)
    out["bmp24_top_down.bmp"] = bmp(bgr, 24, top_down=True)
    bgra = np.concatenate([bgr, grey[..., None]], -1)
    out["bmp32.bmp"] = bmp(bgra, 32)
    out["bmp32_bitfields.bmp"] = bmp(bgra, 32, compression=3,
                                     masks=(0xFF0000, 0xFF00, 0xFF))
    out["bmp24_odd_width.bmp"] = bmp(bgr[:, :33], 24)
    out["bmp_cv2_colour.bmp"] = _cv(".bmp", bgr)
    # the 12-byte OS/2 header: every palette entry present, 3 bytes each
    for d in (1, 4, 8):
        idx = (grey.astype(np.int64) << d) >> 8
        out[f"bmp_os2_{d}.bmp"] = bmp(idx, d, (pal16 if d < 8 else pal)
                                      [:1 << d], os2=True)
    out["bmp_os2_24.bmp"] = bmp(bgr, 24, os2=True)
    out["bmp_os2_24_odd_width.bmp"] = bmp(bgr[:, :33], 24, os2=True)
    out["bmp_os2_32.bmp"] = bmp(bgra, 32, os2=True)

    # TIFF: OpenCV's and PIL's files, then the layouts written here
    c = cv2
    comp = {"none": c.IMWRITE_TIFF_COMPRESSION_NONE,
            "lzw": c.IMWRITE_TIFF_COMPRESSION_LZW,
            "deflate": c.IMWRITE_TIFF_COMPRESSION_DEFLATE,
            "adobe_deflate": c.IMWRITE_TIFF_COMPRESSION_ADOBE_DEFLATE,
            "packbits": c.IMWRITE_TIFF_COMPRESSION_PACKBITS}
    for k, v in comp.items():
        out[f"tiff_cv2_{k}_grey.tif"] = _cv(".tif", grey, [
            c.IMWRITE_TIFF_COMPRESSION, v])
        out[f"tiff_cv2_{k}_colour.tif"] = _cv(".tif", bgr, [
            c.IMWRITE_TIFF_COMPRESSION, v])
    out["tiff_cv2_default.tif"] = _cv(".tif", big)
    out["tiff_cv2_lzw_no_predictor.tif"] = _cv(".tif", grey, [
        c.IMWRITE_TIFF_COMPRESSION, comp["lzw"],
        c.IMWRITE_TIFF_PREDICTOR, c.IMWRITE_TIFF_PREDICTOR_NONE])
    out["tiff_cv2_grey16.tif"] = _cv(".tif", g16.astype(np.uint16))
    out["tiff_cv2_colour16.tif"] = _cv(".tif", r16[..., ::-1].astype(np.uint16))
    out["tiff_cv2_rows_per_strip.tif"] = _cv(".tif", big, [
        c.IMWRITE_TIFF_ROWSPERSTRIP, 7])
    out["tiff_pil_lzw.tif"] = _pil(rgb, "TIFF", compression="tiff_lzw")
    out["tiff_pil_deflate.tif"] = _pil(grey, "TIFF", compression="tiff_deflate")
    out["tiff_pil_packbits.tif"] = _pil(rgb, "TIFF", compression="packbits")
    out["tiff_pil_bilevel.tif"] = _pil(
        __import__("PIL.Image", fromlist=["Image"]).fromarray(grey > 128),
        "TIFF")
    for name, comp_id in (("none", 1), ("lzw", 5), ("deflate", 8),
                          ("adobe_deflate", 32946), ("packbits", 32773)):
        for pred in (1, 2):
            if comp_id == 1 and pred == 2:
                continue
            for bo, tag in (("<", "II"), (">", "MM")):
                out[f"tiff_{name}_p{pred}_{tag}_grey.tif"] = tiff(
                    grey, compression=comp_id, predictor=pred, bo=bo,
                    rows_per_strip=8)
            # (libtiff refuses uncompressed tiles of under 1,024 bytes)
            out[f"tiff_{name}_p{pred}_tiles_rgb.tif"] = tiff(
                rgb, compression=comp_id, predictor=pred,
                tile=(16, 16) if comp_id != 1 else (32, 32))
            out[f"tiff_{name}_p{pred}_grey16_MM.tif"] = tiff(
                g16, bits=16, compression=comp_id, predictor=pred, bo=">",
                rows_per_strip=5)
    out["tiff_rgb16_II.tif"] = tiff(r16, bits=16, rows_per_strip=4)
    out["tiff_rgb16_tiles_lzw_p2.tif"] = tiff(r16, bits=16, compression=5,
                                              predictor=2, tile=(16, 32))
    out["tiff_planar_rgb.tif"] = tiff(rgb, planar=2, rows_per_strip=10)
    out["tiff_planar_rgb_lzw_tiles.tif"] = tiff(rgb, planar=2, compression=5,
                                                tile=(16, 16))
    out["tiff_rgba.tif"] = tiff(np.concatenate([rgb, grey[..., None]], -1),
                                extra_samples=2, compression=8)
    out["tiff_rgba_unassociated_MM.tif"] = tiff(
        np.concatenate([rgb, 255 - grey[..., None]], -1), extra_samples=2,
        bo=">")
    bits1 = (grey > 120).astype(np.uint8)
    out["tiff_bilevel_min_is_black.tif"] = tiff(bits1, bits=1, photometric=1)
    out["tiff_bilevel_min_is_white.tif"] = tiff(bits1, bits=1, photometric=0,
                                                compression=32773)
    out["tiff_bilevel_tiles_lzw.tif"] = tiff(bits1, bits=1, compression=5,
                                             tile=(16, 16))
    out["tiff_grey_min_is_white.tif"] = tiff(grey, photometric=0,
                                             compression=5)
    cmap = rng.integers(0, 65536, (256, 3))
    out["tiff_palette8.tif"] = tiff((grey.astype(np.int64) * 256) >> 8,
                                    photometric=3, colormap=cmap)
    cmap8 = rng.integers(0, 256, (16, 3))            # an 8-bit colour map
    out["tiff_palette4_8bit_map.tif"] = tiff(
        (grey.astype(np.int64) * 16) >> 8, bits=4, photometric=3,
        colormap=cmap8, compression=8)
    out["tiff_two_pages.tif"] = tiff(grey, pages=2, compression=5)
    for o in range(1, 9):
        out[f"tiff_orientation_o{o}.tif"] = tiff(grey, orientation=o,
                                                 rows_per_strip=8)
    out["tiff_orientation_rgb_o6.tif"] = tiff(rgb, orientation=6,
                                              compression=5, predictor=2)
    out["tiff_orientation_tiles_o7.tif"] = tiff(grey, orientation=7,
                                                compression=8, tile=(16, 16))
    return out


# --- the prints of the card's formats phase ------------------------------------

PRINT_H, PRINT_W = 320, 240
# the slots of the card's formats tree: kind i replaces the (i // 4)-th
# print (names sorted) of subject FORMAT_SUBJECTS[i % 4] of
# tools/polyu_set.py's tree, and is that very print (its seed and ridge
# phase), so the tree's genuine pairs stay genuine
FORMAT_SUBJECTS = (1, 2, 3, 4)
PHASE_STEP = 0.06                 # tools/polyu_set.py's


def print_pixels(subject: int, j: int) -> np.ndarray:
    """The uint8 print ``tools/polyu_set.py`` draws for the ``j``-th name
    of ``subject``."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        blob_prints)
    return np.round(blob_prints([10 + subject], [PHASE_STEP * j], PRINT_H,
                                PRINT_W)[0] * 255.0).astype(np.uint8)


def print_cases() -> dict[str, bytes]:
    """{file name: bytes} under ``prints/``: each format file, and for the
    JPEGs ``base_<name>.jpg``, the baseline twin."""
    import cv2
    out = {}
    kinds = ["progressive.jpg", "progressive_colour.jpg", "none.tif",
             "deflate.tif", "packbits.tif", "grey16.png", "palette.png",
             "adam7.png", "bmp32.bmp", "rle8.bmp", "exif_o6.png",
             "exif_o3.tif"]
    for k, kind in enumerate(kinds):
        x = print_pixels(FORMAT_SUBJECTS[k % 4], k // 4)
        stem = kind.rsplit(".", 1)[0]
        base = _cv(".jpg", x, [cv2.IMWRITE_JPEG_QUALITY, 95])
        if kind.endswith(".jpg"):
            out[f"base_{stem}.jpg"] = base
        p = cv2.imdecode(np.frombuffer(base, np.uint8), cv2.IMREAD_GRAYSCALE)
        if kind == "progressive.jpg":
            data = _cv(".jpg", x, [cv2.IMWRITE_JPEG_QUALITY, 95,
                                   cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        elif kind == "progressive_colour.jpg":
            data = _cv(".jpg", np.repeat(x[..., None], 3, 2), [
                cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        elif kind == "none.tif":
            data = tiff(p, rows_per_strip=32)
        elif kind == "deflate.tif":
            data = tiff(p, compression=8, predictor=2, rows_per_strip=64)
        elif kind == "packbits.tif":
            data = tiff(p, compression=32773, tile=(64, 64))
        elif kind == "grey16.png":
            data = png(p.astype(np.int64) * 257, 16, 0)
        elif kind == "palette.png":
            data = png(p, 8, 3, palette=np.repeat(np.arange(256)[:, None], 3, 1))
        elif kind == "adam7.png":
            data = png(p, 8, 0, interlace=True)
        elif kind == "bmp32.bmp":
            data = bmp(np.repeat(p[..., None], 4, 2), 32)
        elif kind == "rle8.bmp":
            data = bmp(p, 8, np.repeat(np.arange(256)[:, None], 3, 1),
                       compression=1)
        elif kind == "exif_o6.png":
            # stored turned a quarter anticlockwise; 6 turns it back
            data = png(np.ascontiguousarray(np.rot90(p, 1)), 8, 0,
                       exif=exif_block(6))
        else:
            # stored upside down; 3 turns it back (a TIFF, not 5 to 8:
            # OpenCV 5.0's imread refuses those where imdecode reads them)
            data = tiff(np.ascontiguousarray(p[::-1, ::-1]), orientation=3,
                        compression=5, predictor=2)
        out[kind] = data
    return out


def digest(img) -> dict:
    if img is None:
        return None
    return {"shape": list(img.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


def cv2_decode(data: bytes):
    """OpenCV's grey and RGB decode of a file's bytes (None where it
    cannot)."""
    import cv2
    buf = np.frombuffer(data, np.uint8)
    g = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    c = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    return g, (None if c is None else np.ascontiguousarray(c[..., ::-1]))


def expected(files: dict[str, bytes]) -> dict:
    out = {}
    for name, data in sorted(files.items()):
        g, c = cv2_decode(data)
        out[name] = {"gray": digest(g), "rgb": digest(c)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests/fixtures/formats"))
    args = ap.parse_args()
    out = Path(args.out)
    files = cases()
    files.update({f"prints/{k}": v for k, v in print_cases().items()})
    for name, data in files.items():
        (out / name).parent.mkdir(parents=True, exist_ok=True)
        (out / name).write_bytes(data)
    (out / "expected.json").write_text(json.dumps(expected(files), indent=1,
                                                  sort_keys=True) + "\n")
    total = sum(len(v) for v in files.values())
    print(f"{len(files)} files, {total} bytes under {out}")


if __name__ == "__main__":
    main()
