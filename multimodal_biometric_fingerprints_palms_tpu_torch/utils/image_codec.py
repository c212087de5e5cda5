"""The port's image codec, in numpy and ``zlib`` only: what OpenCV does for
the JAX package's file runners. Reading gives ``cv2.imdecode(...,
IMREAD_GRAYSCALE)`` or, for ``decode_rgb``, ``IMREAD_COLOR`` then
``COLOR_BGR2RGB``: shape and pixels equal (``tests/test_torch_formats.py``
holds every kind below against OpenCV).

Read:

- JPEG, baseline (SOF0/SOF1) and progressive (SOF2, ``jpeg_progressive.py``),
  Huffman-coded, 8-bit, 1, 3 or 4 components, any integral sampling
  factors, interleaved or not, restart markers, tables defined between
  scans. The colour space is libjpeg's guess (JFIF and Adobe markers,
  component ids): grey, YCbCr, RGB, CMYK or YCCK. Grey of a YCbCr file is
  the luma plane through libjpeg's integer ``JDCT_ISLOW`` inverse DCT;
  colour adds libjpeg-turbo's fancy upsampling (h2v1, h2v2, h1v2 triangle
  filters, box replication otherwise) and its fixed-point
  ``ycc_rgb_convert``. An RGB-coded file keeps its samples (grey through
  libjpeg's ``rgb_gray_convert``); CMYK and YCCK (``ycck_cmyk_convert``)
  go through OpenCV's own ``icvCvt_CMYK2BGR`` and ``icvCvt_CMYK2Gray``.
- PNG of every colour type and bit depth (1, 2, 4, 8, 16), palette, Adam7
  interlacing, all five filters: 16 bits cut to their high byte, low depths
  scaled, alpha and ``tRNS`` dropped, colour to grey by libpng's
  ``rgb_to_gray`` with OpenCV's weights.
- BMP of 1, 4, 8 (palette; 4 and 8 also RLE), 16 (5-5-5, 5-6-5 bit
  fields), 24 and 32 bits, rows either way up, as OpenCV's own reader;
  also with the 12-byte OS/2 header (not at 16 bits, which OpenCV
  refuses).
- TIFF (``tiff.py``): strips or tiles, none, LZW, Deflate, PackBits, JPEG
  (decoded here) or CCITT (``ccitt.py``), predictors 1 and 2, either fill
  order, 1 to 16 bits, grey, RGB, RGBA, palette, YCbCr, CMYK and CIELab,
  as libtiff's RGBA reader gives them to OpenCV.
- The EXIF orientation of JPEG (APP1), PNG (``eXIf``) and TIFF (tag 274)
  files turns the pixels as OpenCV's readers turn them
  (``orientation_tags.py``).

Write: baseline JPEG of grey or BGR (4:4:4) at quality 95, PNG of grey or
BGR, 8-bit grey BMP, and TIFF of grey or BGR (LZW, horizontal predictor,
OpenCV's strip height); the JPEG and TIFF files are byte-equal to
``cv2.imwrite``'s.

Refused, with ``ImageFormatError`` naming the file and the kind:
arithmetic-coded, lossless, hierarchical and 12-bit JPEG; a progressive
JPEG whose scans stop early (libjpeg would show it smoothed); TIFF with
RLEW, old-style JPEG or any other compression, float samples, or another
photometric interpretation (``tiff.py``); every other format (GIF, WebP,
...).

``codec_base.py`` holds what the codec's modules share (the error, the
zigzag order, the bit windows). The baseline Huffman decoder runs vectorised over every bit position of
the scan: where the AC symbol that would start there ends, and where the
symbol after it ends (pointer doubling), so that the walk from one block
to the next takes a lookup per two symbols in Python; the coefficients are
then read for all blocks at once (no loop over coefficients).
"""

from __future__ import annotations

import functools
import struct
import zlib
from pathlib import Path

import numpy as np

from .codec_base import ZIGZAG, ImageFormatError, bit_windows
from .jpeg_progressive import check_complete, decode_progressive_scan
from .orientation_tags import (
    apply_orientation, jpeg_orientation, png_orientation)
from .tiff import TIFF_SIGNATURES, decode_tiff, encode_tiff

# --- JPEG tables -----------------------------------------------------------

# IJG base quantization tables (natural order), JPEG standard Annex K.1
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])

# standard Huffman tables, Annex K.3: (BITS[1..16], HUFFVAL)
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
              tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433"
    "627282090a161718191a25262728292a3435363738393a434445464748494a535455"
    "565758595a636465666768696a737475767778797a838485868788898a9293949596"
    "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4"
    "d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f01562"
    "72d10a162434e125f11718191a262728292a35363738393a434445464748494a5354"
    "55565758595a636465666768696a737475767778797a82838485868788898a929394"
    "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2"
    "d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# bit length of |v| for |v| < 4096 (the JPEG "size" category)
_SIZE = np.array([int(v).bit_length() for v in range(4096)], np.int64)

# libjpeg's jidctint.c constants (CONST_BITS 13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(
    f0_298631336=2446, f0_390180644=3196, f0_541196100=4433,
    f0_765366865=6270, f0_899976223=7373, f1_175875602=9633,
    f1_501321110=12299, f1_847759065=15137, f1_961570560=16069,
    f2_053119869=16819, f2_562915447=20995, f3_072711026=25172)

_SOF_NAMES = {
    0xC3: "lossless JPEG",
    0xC5: "hierarchical JPEG", 0xC6: "hierarchical progressive JPEG",
    0xC7: "hierarchical lossless JPEG", 0xC9: "arithmetic-coded JPEG",
    0xCA: "arithmetic-coded progressive JPEG",
    0xCB: "arithmetic-coded lossless JPEG",
    0xCD: "arithmetic-coded hierarchical JPEG",
    0xCE: "arithmetic-coded hierarchical progressive JPEG",
    0xCF: "arithmetic-coded hierarchical lossless JPEG"}


def _huff_codes(bits, vals):
    """(code, length) per symbol of a canonical Huffman table (Annex C)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]] = c
            length[vals[k]] = n
            c += 1
            k += 1
        c <<= 1
    return code, length


class _HuffLut:
    """A decoding table over 16-bit windows: code length and symbol (length
    0 where no code fits), and for the walk the bits a DC symbol takes with
    its magnitude bits, and for an AC symbol those bits and the coefficients
    it advances (64 for an end of block)."""

    def __init__(self, bits, vals):
        self.length = np.zeros(1 << 16, np.intp)
        self.sym = np.zeros(1 << 16, np.intp)
        c, k = 0, 0
        for n, count in enumerate(bits, start=1):
            for _ in range(count):
                if c >= 1 << n:
                    raise ImageFormatError("bad Huffman table")
                self.length[c << (16 - n):(c + 1) << (16 - n)] = n
                self.sym[c << (16 - n):(c + 1) << (16 - n)] = vals[k]
                c += 1
                k += 1
            c <<= 1
        self.bad = self.length == 0
        size, run = self.sym & 15, self.sym >> 4
        # an invalid code is stepped over as 16 bits (its symbol reads 0)
        self.dc_step = np.where(self.bad, 16, self.length + self.sym)
        self.ac_step = np.where(self.bad, 16, self.length + size).astype(
            np.int16)
        self.ac_adv = np.where(size > 0, run + 1, np.where(
            run == 15, 16, 64)).astype(np.int16)


@functools.lru_cache(maxsize=16)
def _huff_lut(bits: tuple, vals: bytes) -> _HuffLut:
    """Files mostly carry the same few tables: build each once."""
    return _HuffLut(bits, vals)


# --- JPEG decode -----------------------------------------------------------

def _scan_segments(data: bytes, start: int) -> tuple[list[bytes], int]:
    """The entropy-coded data after an SOS header, unstuffed and split at
    restart markers. Returns (segments, offset of the marker that ends the
    scan)."""
    arr = np.frombuffer(data, np.uint8)
    ffs = np.flatnonzero(arr[start:] == 0xFF) + start
    segments, pieces, pos = [], [], start
    skip_to = -1
    for f in ffs.tolist():
        if f < skip_to:
            continue
        j = f + 1
        while j < len(data) and data[j] == 0xFF:    # fill bytes
            j += 1
        if j >= len(data):
            raise ImageFormatError("truncated JPEG scan")
        m = data[j]
        if m == 0x00:                                # stuffed 0xFF data byte
            pieces.append(data[pos:f + 1])
            pos = skip_to = j + 1
        elif 0xD0 <= m <= 0xD7:                      # restart marker
            pieces.append(data[pos:f])
            segments.append(b"".join(pieces))
            pieces, pos = [], j + 1
            skip_to = pos
        else:
            pieces.append(data[pos:f])
            segments.append(b"".join(pieces))
            return segments, f
    raise ImageFormatError("JPEG scan without an end marker")


class _AcJumps:
    """Per bit position of a scan: where the AC symbol that would start
    there ends and how many coefficients it advances (64 for an end of
    block), and the same for pairs of symbols. (Runs of 4 to 32 symbols
    save steps of the walk in Python but cost more in numpy than they save
    on 320x240 frames, and single symbols leave every step to Python:
    pairs measured fastest.)"""
    LEVELS = 2

    def __init__(self, lut: _HuffLut, win: np.ndarray, npos: int):
        w = win[:npos]
        jump = np.minimum(np.arange(npos) + lut.ac_step[w], npos - 1)
        self.jumps, self.advs = [jump], [lut.ac_adv[w]]
        for _ in range(self.LEVELS - 1):
            j, a = self.jumps[-1], self.advs[-1]
            self.jumps.append(j[j])
            self.advs.append(np.minimum(a + a[j], 64))

    def block_end(self, q: int) -> int:
        """Bit position after the AC symbols of a block starting at ``q``:
        the most symbols whose advances stay under 63, then one more."""
        acc, cur = 0, q
        top = self.LEVELS - 1
        a_top, j_top = self.advs[top], self.jumps[top]
        while True:
            a = a_top.item(cur)
            if acc + a >= 63:
                break
            acc += a
            cur = j_top.item(cur)
        for j in range(top - 1, -1, -1):
            a = self.advs[j].item(cur)
            if acc + a < 63:
                acc += a
                cur = self.jumps[j].item(cur)
        return self.jumps[0].item(cur)


def _extend(bits, size):
    """JPEG's sign extension of ``size``-bit magnitude categories."""
    return np.where(bits < (1 << np.maximum(size - 1, 0)),
                    bits - (1 << size) + 1, bits)


def _idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` on (N, 64) natural-order coefficients:
    (N, 8, 8) uint8 samples."""
    f = _F
    ws = (coef.astype(np.int64) * qt[None, :].astype(np.int64)).reshape(
        -1, 8, 8)

    def one_pass(v, shift):
        # v[..., i]: the i-th input of the 1-D transform
        z2, z3 = v[..., 2], v[..., 6]
        z1 = (z2 + z3) * f["f0_541196100"]
        tmp2 = z1 + z3 * -f["f1_847759065"]
        tmp3 = z1 + z2 * f["f0_765366865"]
        tmp0 = (v[..., 0] + v[..., 4]) << _CONST_BITS
        tmp1 = (v[..., 0] - v[..., 4]) << _CONST_BITS
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = v[..., 7], v[..., 5], v[..., 3], v[..., 1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * f["f1_175875602"]
        t0 = t0 * f["f0_298631336"]
        t1 = t1 * f["f2_053119869"]
        t2 = t2 * f["f3_072711026"]
        t3 = t3 * f["f1_501321110"]
        z1 = z1 * -f["f0_899976223"]
        z2 = z2 * -f["f2_562915447"]
        z3 = z3 * -f["f1_961570560"] + z5
        z4 = z4 * -f["f0_390180644"] + z5
        t0 = t0 + z1 + z3
        t1 = t1 + z2 + z4
        t2 = t2 + z2 + z3
        t3 = t3 + z1 + z4
        rnd = 1 << (shift - 1)
        out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
               tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
        return np.stack([(o + rnd) >> shift for o in out], axis=-1)

    # pass 1 over columns (inputs along rows), into the 32-bit workspace
    cols = one_pass(np.swapaxes(ws, 1, 2), _CONST_BITS - _PASS1_BITS)
    cols = cols.astype(np.int32).astype(np.int64)       # (N, col, row)
    rows = one_pass(np.swapaxes(cols, 1, 2),
                    _CONST_BITS + _PASS1_BITS + 3)      # (N, row, col)
    # range_limit[x & 1023] of the post-IDCT table: x taken as a 10-bit
    # two's complement value, recentred by 128 and clamped
    s = ((rows + 512) & 1023) - 512 + 128
    return np.clip(s, 0, 255).astype(np.uint8)


class _Frame:
    """What the markers before and between scans set up, and the
    coefficients the scans decode."""

    def __init__(self, want: str):
        self.want = want            # "luma" or "all" components
        self.qt: dict[int, np.ndarray] = {}
        self.dc: dict[int, _HuffLut] = {}
        self.ac: dict[int, _HuffLut] = {}
        self.restart = 0
        self.size = None            # (H, W)
        self.comps = []             # [(id, h, v, tq)]
        self.progressive = False
        self.adobe_transform = None
        self.jfif = False
        self.color = None           # colour space, fixed at the first scan
        self.coef = {}              # component -> (gy, gx, 64) int32
        self.coef_bits = {}         # component -> last Al of each term
        self.latched = {}           # component -> its table at first scan

    def start(self, size, comps, progressive: bool) -> None:
        self.size, self.comps, self.progressive = size, comps, progressive
        h, w = size
        hmax = max(c[1] for c in comps)
        vmax = max(c[2] for c in comps)
        my, mx = -(-h // (8 * vmax)), -(-w // (8 * hmax))
        self.coef = {ci: np.zeros((my * c[2], mx * c[1], 64), np.int32)
                     for ci, c in enumerate(comps)}

    def wanted(self, ci: int) -> bool:
        return ci == 0 or self.want == "all"

    def comp_blocks(self, ci: int) -> tuple[int, int]:
        """(rows, columns) of a component's own blocks, which a scan of it
        alone covers (the MCU-padded grid holds more)."""
        h, w = self.size
        _, ch, cv, _ = self.comps[ci]
        hmax = max(c[1] for c in self.comps)
        vmax = max(c[2] for c in self.comps)
        return -(-(-(-h * cv // vmax)) // 8), -(-(-(-w * ch // hmax)) // 8)

    def mcu_layout(self, scan) -> tuple[int, list, tuple]:
        """(MCU count, the blocks of one MCU as scan entries, the MCU grid):
        a scan of one component walks its own blocks one at a time."""
        if len(scan) == 1:
            bh, bw = self.comp_blocks(scan[0][0])
            return bw * bh, [scan[0]], (bh, bw)
        h, w = self.size
        hmax = max(c[1] for c in self.comps)
        vmax = max(c[2] for c in self.comps)
        mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        pattern = [s for s in scan for _ in range(self.comps[s[0]][1]
                                                  * self.comps[s[0]][2])]
        return mx * my, pattern, (my, mx)

    def latch(self, ci: int) -> None:
        """libjpeg keeps the quantization table a component has when its
        first scan starts (``latch_quant_tables``)."""
        if ci not in self.latched:
            tq = self.comps[ci][3]
            if tq not in self.qt:
                raise ImageFormatError("undefined quantization table")
            self.latched[ci] = self.qt[tq].copy()


def _scan_header(fr: _Frame, data: bytes, hdr: int, length: int):
    """The scan's [(component, dc table, ac table)] and (Ss, Se, Ah, Al)."""
    ns = data[hdr]
    if length != 6 + 2 * ns or ns == 0:
        raise ImageFormatError("bad SOS length")
    ids = [c[0] for c in fr.comps]
    scan = []
    for i in range(ns):
        cid, tables = data[hdr + 1 + 2 * i], data[hdr + 2 + 2 * i]
        if cid not in ids:
            raise ImageFormatError("scan names an unknown component")
        scan.append((ids.index(cid), tables >> 4, tables & 15))
    ss, se, a = data[hdr + 1 + 2 * ns:hdr + 4 + 2 * ns]
    return scan, (ss, se, a >> 4, a & 15)


def _place(fr: _Frame, ci: int, coef: np.ndarray, grid, interleaved: bool):
    """Write a component's decoded blocks, in scan order, into its grid."""
    gy, gx = grid
    if not interleaved:
        fr.coef[ci][:gy, :gx] = coef.reshape(gy, gx, 64)
    else:
        _, ch, cv, _ = fr.comps[ci]
        fr.coef[ci][:] = coef.reshape(gy, gx, cv, ch, 64).transpose(
            0, 2, 1, 3, 4).reshape(gy * cv, gx * ch, 64)


def _decode_scan(fr: _Frame, data: bytes, hdr: int, length: int) -> int:
    scan, (ss, se, ah, al) = _scan_header(fr, data, hdr, length)
    segments, end = _scan_segments(data, hdr + length - 2)
    for ci, _, _ in scan:
        fr.latch(ci)
    if not any(fr.wanted(ci) for ci, _, _ in scan):
        return end                   # no wanted component: skip decoding
    if fr.progressive:
        decode_progressive_scan(fr, scan, (ss, se, ah, al), segments)
        return end
    if (ss, se, ah, al) != (0, 63, 0, 0):
        raise ImageFormatError("not a baseline sequential scan")
    n_mcu, pattern, grid = fr.mcu_layout(scan)
    for _, td, ta in scan:
        if td not in fr.dc or ta not in fr.ac:
            raise ImageFormatError("scan uses an undefined Huffman table")

    seg_bytes = [np.frombuffer(s, np.uint8) for s in segments]
    seg_start = np.cumsum([0] + [8 * len(s) for s in seg_bytes]).tolist()
    stream = np.concatenate(seg_bytes) if seg_bytes else np.zeros(0, np.uint8)
    npos = 8 * len(stream) + 1
    win = bit_windows(stream, npos)
    ac = {ta: _AcJumps(fr.ac[ta], win, npos) for _, _, ta in scan}

    # walk the blocks: one DC symbol and one jump chain per block
    ri = fr.restart
    nblk = n_mcu * len(pattern)
    starts = [0] * nblk
    seg_of = [0] * nblk
    pos, seg, b = 0, 0, 0
    tbls = [(fr.dc[td].dc_step, ac[ta]) for _, td, ta in pattern]
    for m in range(n_mcu):
        if ri and m and m % ri == 0:
            seg += 1
            if seg >= len(segments):
                raise ImageFormatError("missing restart marker")
            pos = seg_start[seg]
        for dc_step, jumps in tbls:
            starts[b] = pos
            seg_of[b] = seg
            pos = jumps.block_end(pos + dc_step.item(win.item(pos)))
            b += 1
    starts = np.asarray(starts)
    seg_of = np.asarray(seg_of)
    for ci, td, ta in scan:
        if fr.wanted(ci):
            is_c = np.array([s[0] == ci for s in pattern] * n_mcu)
            coef = _decode_blocks(win, starts[is_c], seg_of[is_c],
                                  fr.dc[td], fr.ac[ta])
            _place(fr, ci, coef, grid, len(scan) > 1)
    return end


def _decode_blocks(win, s_y, seg_y, dl: _HuffLut, al: _HuffLut) -> np.ndarray:
    """(N, 64) natural-order coefficients of one component's blocks of a
    baseline scan, given where each block's bits start, for all blocks at
    once; the DC prediction restarts with each segment."""
    wv = win[s_y]
    if dl.bad[wv].any() or (dl.sym[wv] > 11).any():
        raise ImageFormatError("bad Huffman code in JPEG scan")
    size = dl.sym[wv]
    length = dl.length[wv]
    bits = (win[s_y + length] >> (16 - size)) * (size > 0)
    diff = _extend(bits, size)
    dc = np.cumsum(diff)
    first = np.r_[True, seg_y[1:] != seg_y[:-1]]
    base = np.maximum.accumulate(np.where(first, np.arange(len(dc)), 0))
    dc = dc - (dc[base] - diff[base])       # restart: predictions reset

    nb = len(s_y)
    coef = np.zeros((nb, 64), np.int32)
    coef[:, 0] = dc
    pos = s_y + length + size
    k = np.ones(nb, np.intp)
    act = np.arange(nb)
    while act.size:
        p = pos[act]
        w = win[p]
        if al.bad[w].any():
            raise ImageFormatError("bad Huffman code in JPEG scan")
        sym, length = al.sym[w], al.length[w]
        size, run = sym & 15, sym >> 4
        live = (size > 0) | (run == 15)
        act, p, size, run, length = (act[live], p[live], size[live],
                                     run[live], length[live])
        kk = k[act] + run
        val = size > 0
        bits = win[p + length] >> (16 - size)
        coef[act[val], ZIGZAG[np.minimum(kk[val], 63)]] = _extend(
            bits[val], size[val])
        k[act] = kk + 1
        pos[act] = p + length + size
        act = act[k[act] < 64]
    return coef


def _read_jpeg(data: bytes, name: str, want: str,
               color: str | None = None) -> _Frame:
    """Parse a JPEG file and decode the scans of the wanted components.
    ``color`` overrides the colour space libjpeg would guess
    (``_color_space``), as libtiff does for a TIFF's JPEG strips."""
    if data[:2] != b"\xff\xd8":
        raise ImageFormatError(f"{name}: not a JPEG file")
    fr = _Frame(want)
    i = 2
    while True:
        while i < len(data) and data[i] != 0xFF:
            i += 1
        while i < len(data) and data[i] == 0xFF:
            i += 1
        if i >= len(data):
            raise ImageFormatError(f"{name}: JPEG without EOI")
        m = data[i]
        i += 1
        if m == 0xD9:
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if i + 2 > len(data):
            raise ImageFormatError(f"{name}: truncated JPEG")
        length = struct.unpack(">H", data[i:i + 2])[0]
        seg = data[i + 2:i + length]
        if len(seg) != length - 2:
            raise ImageFormatError(f"{name}: truncated JPEG")
        if m in _SOF_NAMES:
            raise ImageFormatError(
                f"{name}: {_SOF_NAMES[m]} is not supported (baseline and "
                "progressive Huffman-coded JPEG only)")
        if m in (0xC0, 0xC1, 0xC2):
            if fr.size is not None:
                raise ImageFormatError(f"{name}: JPEG with two frame headers")
            if seg[0] != 8:
                raise ImageFormatError(
                    f"{name}: {seg[0]}-bit JPEG is not supported")
            h, w, nf = struct.unpack(">HHB", seg[1:6])
            if h == 0 or w == 0:
                raise ImageFormatError(f"{name}: JPEG without a frame size")
            if nf not in (1, 3, 4):
                raise ImageFormatError(
                    f"{name}: JPEG with {nf} components is not supported")
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                      seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(nf)]
            if any(not (1 <= c[1] <= 4 and 1 <= c[2] <= 4) for c in comps):
                raise ImageFormatError(f"{name}: bad sampling factors")
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            if any(hmax % c[1] or vmax % c[2] for c in comps):
                raise ImageFormatError(
                    f"{name}: fractional sampling factors are not supported")
            if (comps[0][1], comps[0][2]) != (hmax, vmax):
                raise ImageFormatError(
                    f"{name}: luma sampled below chroma is not supported")
            fr.start((h, w), comps, m == 0xC2)
        elif m == 0xC4:
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 15
                bits = tuple(seg[j + 1:j + 17])
                n = sum(bits)
                vals = bytes(seg[j + 17:j + 17 + n])
                (fr.ac if tc else fr.dc)[th] = _huff_lut(bits, vals)
                j += 17 + n
        elif m == 0xDB:
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                if pq:
                    vals = struct.unpack(">64H", seg[j + 1:j + 129])
                    j += 129
                else:
                    vals = tuple(seg[j + 1:j + 65])
                    j += 65
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                fr.qt[tq] = q
        elif m == 0xDD:
            fr.restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xE0 and seg[:5] == b"JFIF\x00":
            fr.jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            fr.adobe_transform = seg[11]
        elif m == 0xDA:
            if fr.size is None:
                raise ImageFormatError(f"{name}: scan before frame header")
            if fr.color is None:
                fr.color = color or _color_space(fr)
                if fr.color not in ("grey", "ycc"):
                    fr.want = "all"     # grey needs every component
            try:
                i = _decode_scan(fr, data, i + 2, length)
            except ImageFormatError as e:
                raise ImageFormatError(f"{name}: {e}") from None
            continue
        i += length
    if fr.size is None or not fr.latched:
        raise ImageFormatError(f"{name}: JPEG without image data")
    if fr.progressive:
        try:
            check_complete(fr)
        except ImageFormatError as e:
            raise ImageFormatError(f"{name}: {e}") from None
    return fr


def _component_plane(fr: _Frame, ci: int) -> np.ndarray:
    """The samples of a component: its blocks through the inverse DCT,
    cut to the component's own size."""
    gy, gx, _ = fr.coef[ci].shape
    px = _idct_islow(fr.coef[ci].reshape(-1, 64), fr.latched[ci])
    plane = px.reshape(gy, gx, 8, 8).transpose(0, 2, 1, 3).reshape(
        gy * 8, gx * 8)
    h, w = fr.size
    _, ch, cv, _ = fr.comps[ci]
    hmax = max(c[1] for c in fr.comps)
    vmax = max(c[2] for c in fr.comps)
    return plane[:-(-h * cv // vmax), :-(-w * ch // hmax)]


def decode_jpeg_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 grey of a baseline or progressive JPEG, equal to
    OpenCV's ``IMREAD_GRAYSCALE`` before the EXIF orientation is applied:
    the luma plane of a grey or YCbCr file, libjpeg's ``rgb_gray_convert``
    of an RGB-coded one, OpenCV's ``icvCvt_CMYK2Gray`` of a CMYK or YCCK
    one."""
    fr = _read_jpeg(data, name, "luma")
    if fr.color in ("grey", "ycc"):
        return np.ascontiguousarray(_component_plane(fr, 0))
    if fr.color == "rgb":
        r, g, b = _planes(fr)
        return ((19595 * r + 38470 * g + 7471 * b + (1 << 15)) >> 16).astype(
            np.uint8)
    c, m, y = _cmyk_rgb(fr)
    return _bgr_to_gray_cv(y, m, c)


def _fancy_pairs(p: np.ndarray, axis: int, bias_lo: int, bias_hi: int,
                 shift: int) -> np.ndarray:
    """libjpeg's triangle filter along ``axis``: each sample becomes two,
    (3 * near + far + bias) >> shift with the far neighbour before it
    (``bias_lo``) and after it (``bias_hi``), the edge sample standing in
    for its missing neighbour."""
    n = p.shape[axis]
    lo = np.take(p, np.r_[0, np.arange(n - 1)], axis=axis)
    hi = np.take(p, np.r_[np.arange(1, n), n - 1], axis=axis)
    a = (3 * p + lo + bias_lo) >> shift
    b = (3 * p + hi + bias_hi) >> shift
    out = np.stack([a, b], axis=axis + 1)
    shape = list(p.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(plane: np.ndarray, hf: int, vf: int, size) -> np.ndarray:
    """libjpeg-turbo's ``jdsample.c`` with fancy upsampling on (its
    default): h2v1 and h2v2 triangle filters where the component is wider
    than 2 samples, h1v2 always, box replication for every other integral
    factor."""
    h, w = size
    p = plane.astype(np.int64)
    dw = plane.shape[1]
    if (hf, vf) == (1, 1):
        out = p
    elif (hf, vf) == (2, 1) and dw > 2:
        out = _fancy_pairs(p, 1, 1, 2, 2)
    elif (hf, vf) == (1, 2):
        out = _fancy_pairs(p, 0, 1, 2, 2)
    elif (hf, vf) == (2, 2) and dw > 2:
        n = p.shape[0]
        up = p[np.r_[0, np.arange(n - 1)]]
        dn = p[np.r_[np.arange(1, n), n - 1]]
        colsum = np.stack([3 * p + up, 3 * p + dn], axis=1).reshape(
            2 * n, -1)
        out = _fancy_pairs(colsum, 1, 8, 7, 4)
    else:
        out = np.repeat(np.repeat(p, vf, axis=0), hf, axis=1)
    return out[:h, :w]


def _ycc_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert``: 16-bit fixed-point tables, R and B
    rounded in the table, G's two products summed then shifted."""
    half = 1 << 15
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((91881 * x_cr + half) >> 16)
    g = y + ((-22554 * x_cb + half - 46802 * x_cr) >> 16)
    b = y + ((116130 * x_cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _planes(fr: _Frame) -> list[np.ndarray]:
    """Every component's samples, upsampled to the frame's size (int64)."""
    hmax = max(c[1] for c in fr.comps)
    vmax = max(c[2] for c in fr.comps)
    return [_upsample(_component_plane(fr, ci), hmax // c[1], vmax // c[2],
                      fr.size) for ci, c in enumerate(fr.comps)]


def _cmyk_rgb(fr: _Frame) -> list[np.ndarray]:
    """R, G, B planes of a CMYK or YCCK file as OpenCV's JPEG reader makes
    them: libjpeg gives CMYK (YCCK through ``ycck_cmyk_convert``: C, M, Y
    are 255 less the YCbCr conversion, K as stored), then
    ``icvCvt_CMYK2BGR`` takes the Adobe-style inverted samples:
    ``k - ((255 - c) * k >> 8)``."""
    p = _planes(fr)
    if fr.color == "ycck":
        cmy = 255 - _ycc_rgb(*p[:3]).astype(np.int64)
        p = [cmy[..., 0], cmy[..., 1], cmy[..., 2], p[3]]
    k = p[3]
    return [k - ((255 - v) * k >> 8) for v in p[:3]]


def decode_jpeg_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a baseline or progressive JPEG, equal to
    OpenCV's ``IMREAD_COLOR`` (then ``COLOR_BGR2RGB``) before the EXIF
    orientation is applied: a grey file repeats its grey; a YCbCr file's
    chroma is upsampled and converted as libjpeg-turbo does; an RGB-coded
    file keeps its upsampled samples; CMYK and YCCK as ``_cmyk_rgb``."""
    fr = _read_jpeg(data, name, "all")
    if fr.color == "grey":
        return np.repeat(_component_plane(fr, 0)[..., None], 3, axis=2)
    if fr.color in ("cmyk", "ycck"):
        return np.stack(_cmyk_rgb(fr), axis=-1).astype(np.uint8)
    p = _planes(fr)
    if fr.color == "ycc":
        return _ycc_rgb(*p)
    return np.stack(p, axis=-1).astype(np.uint8)


def decode_jpeg_samples(data: bytes, name: str,
                        ycc: bool) -> tuple[np.ndarray, list]:
    """((H, W, components) uint8 samples, the frame's components) of a JPEG
    as libtiff's JPEG codec gives a TIFF strip: YCbCr converted to RGB by
    libjpeg where ``ycc``, else every component as coded, upsampled."""
    fr = _read_jpeg(data, name, "all", "ycc" if ycc else "rgb")
    p = _planes(fr)
    if ycc:
        if len(p) != 3:
            raise ImageFormatError(f"{name}: YCbCr JPEG of {len(p)} "
                                   "components")
        return _ycc_rgb(*p), fr.comps
    return np.stack(p, axis=-1).astype(np.uint8), fr.comps


def _color_space(fr: _Frame) -> str:
    """libjpeg's guess of the colour space (``default_decompress_parms``):
    "grey", "ycc", "rgb", "cmyk" or "ycck"."""
    if len(fr.comps) == 1:
        return "grey"
    if len(fr.comps) == 4:
        if fr.adobe_transform is None or fr.adobe_transform == 0:
            return "cmyk"
        return "ycck"
    if fr.jfif:
        return "ycc"
    if fr.adobe_transform is not None:
        return "ycc" if fr.adobe_transform else "rgb"
    return ("rgb" if [c[0] for c in fr.comps] == [ord("R"), ord("G"), ord("B")]
            else "ycc")


# --- JPEG encode -----------------------------------------------------------

def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG ``jpeg_set_quality`` scaling (baseline: entries in 1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_fdct_islow`` on (N, 8, 8) level-shifted samples:
    (N, 8, 8) coefficients scaled up by 8, as libjpeg quantizes them."""
    f = _F

    def one_pass(v, shift_even, shift_odd):
        # v[..., i]: the i-th input of the 1-D transform
        t0, t7 = v[..., 0] + v[..., 7], v[..., 0] - v[..., 7]
        t1, t6 = v[..., 1] + v[..., 6], v[..., 1] - v[..., 6]
        t2, t5 = v[..., 2] + v[..., 5], v[..., 2] - v[..., 5]
        t3, t4 = v[..., 3] + v[..., 4], v[..., 3] - v[..., 4]
        t10, t13 = t0 + t3, t0 - t3
        t11, t12 = t1 + t2, t1 - t2

        def descale(x, n):
            return (x + (1 << (n - 1))) >> n if n else x

        out = [None] * 8
        out[0] = descale(t10 + t11, shift_even) if shift_even > 0 else (
            (t10 + t11) << -shift_even)
        out[4] = descale(t10 - t11, shift_even) if shift_even > 0 else (
            (t10 - t11) << -shift_even)
        z1 = (t12 + t13) * f["f0_541196100"]
        out[2] = descale(z1 + t13 * f["f0_765366865"], shift_odd)
        out[6] = descale(z1 + t12 * -f["f1_847759065"], shift_odd)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * f["f1_175875602"]
        t4 = t4 * f["f0_298631336"]
        t5 = t5 * f["f2_053119869"]
        t6 = t6 * f["f3_072711026"]
        t7 = t7 * f["f1_501321110"]
        z1 = z1 * -f["f0_899976223"]
        z2 = z2 * -f["f2_562915447"]
        z3 = z3 * -f["f1_961570560"] + z5
        z4 = z4 * -f["f0_390180644"] + z5
        out[7] = descale(t4 + z1 + z3, shift_odd)
        out[5] = descale(t5 + z2 + z4, shift_odd)
        out[3] = descale(t6 + z2 + z3, shift_odd)
        out[1] = descale(t7 + z1 + z4, shift_odd)
        return np.stack(out, axis=-1)

    # pass 1 over rows: even outputs shifted up by PASS1_BITS
    rows = one_pass(blocks.astype(np.int64), -_PASS1_BITS,
                    _CONST_BITS - _PASS1_BITS)
    rows = rows.astype(np.int32).astype(np.int64)      # DCTELEM workspace
    cols = one_pass(np.swapaxes(rows, 1, 2), _PASS1_BITS,
                    _CONST_BITS + _PASS1_BITS)         # (N, col, row)
    return np.swapaxes(cols, 1, 2)


def _plane_blocks(plane: np.ndarray) -> np.ndarray:
    """(nby * nbx, 8, 8) level-shifted int64 blocks of an (H, W) uint8
    plane, edge replicated to whole blocks (as libjpeg pads)."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.int64), ((0, -h % 8), (0, -w % 8)),
               mode="edge") - 128
    nby, nbx = p.shape[0] // 8, p.shape[1] // 8
    return p.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _quantized_zigzag(blocks: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """libjpeg's quantization of the ISLOW coefficients (divisor 8 * q,
    rounded half away from zero), in zigzag order."""
    coef = _fdct_islow(blocks).reshape(-1, 64)
    div = (qt.astype(np.int64) << 3)[None, :]
    q = np.sign(coef) * ((np.abs(coef) + (div >> 1)) // div)
    zz = q[:, ZIGZAG]
    zz[:, 1:] = np.clip(zz[:, 1:], -1023, 1023)
    return zz


def _rgb_ycc(img: np.ndarray) -> list[np.ndarray]:
    """libjpeg's ``rgb_ycc_convert`` (16-bit fixed point) of a BGR array:
    the Y, Cb and Cr planes as uint8."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16
    return [p.astype(np.uint8) for p in (y, cb, cr)]


def _entropy_code(zz: np.ndarray, comp: np.ndarray, ncomp: int,
                  tables: list) -> bytes:
    """Huffman-code (N, 64) zigzag blocks in stream order; ``comp`` is each
    block's component, ``tables[c]`` its (dc codes, ac codes)."""
    nb = zz.shape[0]
    # DC differences per component
    diff = np.empty(nb, np.int64)
    for c in range(ncomp):
        sel = np.flatnonzero(comp == c)
        d = zz[sel, 0]
        diff[sel] = np.diff(d, prepend=0)
    dsize = _SIZE[np.abs(diff)]
    dbits = np.where(diff < 0, diff + (1 << dsize) - 1, diff)
    dc_code = np.empty(nb, np.int64)
    dc_len = np.empty(nb, np.int64)
    ac_code_tab = np.stack([t[1][0] for t in tables])
    ac_len_tab = np.stack([t[1][1] for t in tables])
    for c in range(ncomp):
        sel = comp == c
        code, length = tables[c][0]
        dc_code[sel] = (code[dsize[sel]] << dsize[sel]) | dbits[sel]
        dc_len[sel] = length[dsize[sel]] + dsize[sel]

    # AC: nonzero coefficients in stream order, their zero runs split
    # into ZRL (16 zeros) symbols and a (run, size) symbol
    nz = zz[:, 1:] != 0
    bi, ki = np.nonzero(nz)
    k = ki + 1
    first = np.r_[True, bi[1:] != bi[:-1]] if bi.size else np.zeros(0, bool)
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    nzrl = run >> 4
    val = zz[bi, k]
    size = _SIZE[np.abs(val)]
    vbits = np.where(val < 0, val + (1 << size) - 1, val)
    tb = comp[bi]
    sym = ((run & 15) << 4) | size
    ac_code = (ac_code_tab[tb, sym] << size) | vbits
    ac_len = ac_len_tab[tb, sym] + size
    last = np.zeros(nb, np.int64)
    if bi.size:
        last[bi[~np.r_[bi[1:] == bi[:-1], False]]] = k[
            ~np.r_[bi[1:] == bi[:-1], False]]
    eob = last < 63

    per_nz = nzrl + 1
    count = 1 + np.bincount(bi, weights=per_nz, minlength=nb).astype(
        np.int64) + eob
    boff = np.r_[0, np.cumsum(count)[:-1]]
    total = int(count.sum())
    codes = np.empty(total, np.int64)
    lens = np.empty(total, np.int64)
    codes[boff] = dc_code
    lens[boff] = dc_len
    cs = np.r_[0, np.cumsum(per_nz)[:-1]]
    first_of_block = np.zeros(nb, np.int64)
    if bi.size:
        first_of_block[bi[first]] = cs[first]
    nz_start = boff[bi] + 1 + cs - first_of_block[bi]
    zrl_n = int(nzrl.sum())
    if zrl_n:
        zpos = (np.repeat(nz_start, nzrl) + np.arange(zrl_n)
                - np.repeat(np.r_[0, np.cumsum(nzrl)[:-1]], nzrl))
        ztb = np.repeat(tb, nzrl)
        codes[zpos] = ac_code_tab[ztb, 0xF0]
        lens[zpos] = ac_len_tab[ztb, 0xF0]
    spos = nz_start + nzrl
    codes[spos] = ac_code
    lens[spos] = ac_len
    epos = (boff + count - 1)[eob]
    codes[epos] = ac_code_tab[comp[eob], 0x00]
    lens[epos] = ac_len_tab[comp[eob], 0x00]

    # bits: no two items share a bit, so each item's (at most 27) bits are
    # added into the one or two big-endian 32-bit words they fall in; the
    # last byte is padded with ones; then 0xFF stuffing
    ends = np.cumsum(lens)
    starts = ends - lens
    nbits = int(ends[-1])
    word = starts >> 5
    v = codes.astype(np.uint64) << (64 - (starts & 31) - lens).astype(np.uint64)
    nwords = nbits // 32 + 2
    words = (np.bincount(word, weights=(v >> np.uint64(32)).astype(np.float64),
                         minlength=nwords)
             + np.bincount(word + 1, weights=(v & np.uint64(0xFFFFFFFF)).astype(
                 np.float64), minlength=nwords))
    out = np.frombuffer(words.astype(np.uint64).astype(">u4").tobytes(),
                        np.uint8)[:-(-nbits // 8)].copy()
    if nbits % 8:
        out[-1] |= (1 << (8 - nbits % 8)) - 1
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _dht(tc: int, th: int, table) -> bytes:
    bits, vals = table
    body = bytes([tc << 4 | th]) + bytes(bits) + bytes(vals)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


def _dqt(tq: int, q: np.ndarray) -> bytes:
    body = bytes([tq]) + bytes(q[ZIGZAG].astype(np.uint8).tolist())
    return b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JPEG of an (H, W) grey or (H, W, 3) BGR uint8 array."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ImageFormatError(
            f"JPEG encode takes (H, W) or (H, W, 3) uint8, not "
            f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if h == 0 or w == 0 or h > 65535 or w > 65535:
        raise ImageFormatError(f"JPEG cannot hold a {h}x{w} image")
    lq = _quant_table(_STD_LUMA_Q, quality)
    cq = _quant_table(_STD_CHROMA_Q, quality)
    luma = (_huff_codes(*_DC_LUMA), _huff_codes(*_AC_LUMA))
    chroma = (_huff_codes(*_DC_CHROMA), _huff_codes(*_AC_CHROMA))
    if img.ndim == 2:
        planes, qts, tables = [img], [lq], [luma]
    else:
        planes, qts, tables = _rgb_ycc(img), [lq, cq, cq], [luma, chroma, chroma]
    zz = [_quantized_zigzag(_plane_blocks(p), qt) for p, qt in zip(planes, qts)]
    ncomp = len(planes)
    stream = np.stack(zz, axis=1).reshape(-1, 64)   # MCU order: Y (Cb Cr)
    comp = np.tile(np.arange(ncomp), zz[0].shape[0])
    data = _entropy_code(stream, comp, ncomp, tables)

    out = [b"\xff\xd8",
           b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00",
           _dqt(0, lq)]
    if ncomp == 3:
        out.append(_dqt(1, cq))
    sof = struct.pack(">BHHB", 8, h, w, ncomp) + b"".join(
        bytes([c + 1, 0x11, min(c, 1)]) for c in range(ncomp))
    out.append(b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof)
    out += [_dht(0, 0, _DC_LUMA), _dht(1, 0, _AC_LUMA)]
    if ncomp == 3:
        out += [_dht(0, 1, _DC_CHROMA), _dht(1, 1, _AC_CHROMA)]
    sos = bytes([ncomp]) + b"".join(
        bytes([c + 1, 0x11 * min(c, 1)]) for c in range(ncomp)) + b"\x00\x3f\x00"
    out.append(b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos)
    out += [data, b"\xff\xd9"]
    return b"".join(out)


# --- PNG -------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ft = int(rows[y, 0])
        f = rows[y, 1:].astype(np.int64)
        if ft == 0:
            cur = f
        elif ft == 1:
            cur = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ft == 2:
            cur = (f + prev) & 0xFF
        elif ft in (3, 4):
            fl, up = f.tolist(), prev.tolist()
            cur_l = [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[x] = (fl[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ImageFormatError(f"bad PNG filter type {ft}")
        out[y] = cur
        prev = cur
    return out


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack_bits(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """(h, stride) bytes of ``depth``-bit samples (MSB first) as (h, n)
    integer samples."""
    if depth == 8:
        return rows[:, :n].astype(np.int64)
    if depth == 16:
        return rows[:, :2 * n].reshape(rows.shape[0], n, 2).astype(
            np.int64) @ np.array([256, 1])
    per = 8 // depth
    shifts = np.arange(per - 1, -1, -1) * depth
    s = (rows.astype(np.int64)[..., None] >> shifts) & ((1 << depth) - 1)
    return s.reshape(rows.shape[0], -1)[:, :n]


class _Png:
    """A PNG's samples, (H, W, channels) integers of its bit depth, and
    what the reader needs beside them."""

    def __init__(self, data: bytes, name: str):
        if data[:8] != _PNG_SIG:
            raise ImageFormatError(f"{name}: not a PNG file")
        i, idat, hdr, self.palette = 8, [], None, None
        while i + 8 <= len(data):
            n, kind = struct.unpack(">I4s", data[i:i + 8])
            body = data[i + 8:i + 8 + n]
            if kind == b"IHDR":
                hdr = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                self.palette = np.frombuffer(body[:len(body) // 3 * 3],
                                             np.uint8).reshape(-1, 3)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
            i += 12 + n
        if hdr is None:
            raise ImageFormatError(f"{name}: PNG without IHDR")
        w, h, depth, ctype, _, _, interlace = hdr
        channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
        allowed = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                   4: (8, 16), 6: (8, 16)}.get(ctype, ())
        if channels is None or depth not in allowed or interlace > 1:
            raise ImageFormatError(
                f"{name}: PNG with bit depth {depth}, colour type {ctype}, "
                f"interlace {interlace} is not a valid PNG")
        if ctype == 3 and self.palette is None:
            raise ImageFormatError(f"{name}: palette PNG without PLTE")
        self.depth, self.ctype = depth, ctype
        try:
            raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        except zlib.error as e:
            raise ImageFormatError(f"{name}: corrupt PNG data: {e}") from None
        bpp = max(1, channels * depth // 8)
        passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
        out = np.zeros((h, w, channels), np.int64)
        at = 0
        for x0, y0, dx, dy in passes:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            stride = -(-(pw * channels * depth) // 8)
            if raw.size < at + ph * (stride + 1):
                raise ImageFormatError(f"{name}: truncated PNG data")
            rows = _png_unfilter(raw[at:at + ph * (stride + 1)], ph, stride,
                                 bpp)
            at += ph * (stride + 1)
            out[y0::dy, x0::dx] = _unpack_bits(
                rows, depth, pw * channels).reshape(ph, pw, channels)
        self.samples = out


def _png_rgb(png: _Png):
    """(samples, bit depth) with palette indices replaced by their RGB
    (libpng's ``png_set_palette_to_rgb``) and grey of 1, 2 or 4 bits
    scaled to 8 (``png_set_expand_gray_1_2_4_to_8``)."""
    s = png.samples
    if png.ctype == 3:
        pal = np.zeros((256, 3), np.int64)
        pal[:len(png.palette)] = png.palette
        return pal[s[..., 0]], 8
    if png.depth < 8:
        return s * (255 // ((1 << png.depth) - 1)), 8
    return s, png.depth


def _png_to_8(s: np.ndarray, depth: int) -> np.ndarray:
    """16-bit samples to 8 as libpng's ``png_set_strip_16`` does: the high
    byte."""
    return (s >> 8 if depth == 16 else s).astype(np.uint8)


def _png_pixels(data: bytes, name: str) -> np.ndarray:
    """(H, W, channels) uint8 samples of a PNG: palette expanded to RGB,
    low bit depths scaled to 8, 16 bits cut to 8 (alpha kept)."""
    s, depth = _png_rgb(_Png(data, name))
    return _png_to_8(s, depth)


def decode_png_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 grey of a PNG, as OpenCV's ``IMREAD_GRAYSCALE`` gives
    it before the EXIF orientation: libpng's ``rgb_to_gray`` with OpenCV's
    weights 0.299 and 0.587 (29900 * 32768 // 100000 and 58700 * 32768 //
    100000 of 32768, the rest blue), truncated, at the file's bit depth
    (a palette's entries at 8), grey pixels kept; then 16 bits to 8; alpha
    dropped."""
    png = _Png(data, name)
    s, depth = _png_rgb(png)
    if s.shape[2] <= 2 and png.ctype != 3:
        return _png_to_8(s[..., 0], depth)
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    gray = (9797 * r + 19234 * g + 3737 * b + (16384 if depth == 16 else 0)
            ) >> 15
    return _png_to_8(np.where((r == g) & (r == b), r, gray), depth)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """8-bit PNG of an (H, W) grey or (H, W, 3) BGR uint8 array."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ImageFormatError(
            f"PNG encode takes (H, W) or (H, W, 3) uint8, not "
            f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    px = img if img.ndim == 2 else img[..., ::-1]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, -1)],
                          axis=1)
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# --- BMP -------------------------------------------------------------------

def _bgr_to_gray_cv(b, g, r):
    """OpenCV's BMP reader's BGR -> grey: 14-bit weights, rounded."""
    return ((1868 * b.astype(np.int64) + 9617 * g.astype(np.int64)
             + 4899 * r.astype(np.int64) + 8192) >> 14).astype(np.uint8)


def _rle_indices(data: bytes, at: int, w: int, h: int, bpp: int,
                 name: str) -> np.ndarray:
    """(H, W) palette indices of an RLE8 or RLE4 BMP, in stored row order,
    as OpenCV's reader fills them: a pixel that an end of line, an end of
    bitmap or a delta steps over takes entry 0; an RLE8 run that ends a
    row ends it (a following end of line is then ignored)."""
    buf = np.zeros(h * w, np.int64)
    pos, y, line_end = 0, 0, w
    wrapped = False

    def fill(count, val):
        nonlocal pos, y, line_end
        while True:
            end = min(pos + count, line_end)
            count -= end - pos
            buf[pos:end] = val
            pos = end
            if pos >= line_end:
                line_end += w
                pos = line_end - w
                y += 1
                if y >= h:
                    break
            if count <= 0:
                break

    i = at
    while True:
        if i + 2 > len(data):
            raise ImageFormatError(f"{name}: truncated RLE data")
        n, code = data[i], data[i + 1]
        i += 2
        if n:                                         # encoded run
            if pos + n > line_end:
                raise ImageFormatError(f"{name}: RLE run past its row")
            if bpp == 8:
                y0 = y
                fill(n, code)
                wrapped = y != y0
            else:
                vals = np.resize([code >> 4, code & 15], n)
                buf[pos:pos + n] = vals
                pos += n
            if y >= h:
                break
        elif code > 2:                                # absolute run
            if pos + code > line_end:
                raise ImageFormatError(f"{name}: RLE run past its row")
            nbytes = code if bpp == 8 else (code + 1) >> 1
            nbytes += nbytes & 1
            raw = np.frombuffer(data[i:i + nbytes], np.uint8)
            if raw.size < nbytes:
                raise ImageFormatError(f"{name}: truncated RLE data")
            i += nbytes
            vals = raw.astype(np.int64) if bpp == 8 else np.stack(
                [raw >> 4, raw & 15], -1).reshape(-1).astype(np.int64)
            buf[pos:pos + code] = vals[:code]
            pos += code
            wrapped = False
        else:                                         # escapes
            step = line_end - pos
            down = h - y
            if code == 2:
                if i + 2 > len(data):
                    raise ImageFormatError(f"{name}: truncated RLE data")
                step, down = data[i], data[i + 1]
                i += 2
            if bpp == 8 and not (code or not wrapped or step < w):
                wrapped = False
                continue
            if code != 0 and bpp == 8:
                step += down * w
            if y >= h:
                break
            fill(step, 0)
            wrapped = False
            if y >= h:
                break
    return buf.reshape(h, w)


def _bmp_pixels(data: bytes, name: str):
    """(pixels, palette) of a BMP as OpenCV's reader takes it, rows top
    first: (H, W) palette indices with the (256, 3) BGR palette, or
    (H, W, 3) BGR and None. 1, 4 and 8 bits a pixel with a palette (4 and
    8 also run-length coded), 16 (5-5-5, or 5-6-5 through bit fields), 24
    and 32 (alpha and bit fields ignored). The 12-byte OS/2 header has
    16-bit sizes, no compression and a palette of 3-byte entries."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ImageFormatError(f"{name}: not a BMP file")
    offset, dib = struct.unpack("<II", data[10:18])
    if dib == 12:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp, ncolors, entry = 0, 0, 3
    elif dib >= 36 and len(data) >= 14 + dib:
        w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        ncolors = struct.unpack("<I", data[46:50])[0]
        entry = 4
    else:
        raise ImageFormatError(f"{name}: BMP header of {dib} bytes is not "
                               "supported")
    ok = (w > 0 and h != 0 and (
        (bpp in (1, 4, 8, 24, 32) and comp == 0)
        or (bpp == 32 and comp == 3)
        or (bpp == 16 and comp in (0, 3) and dib != 12)   # as OpenCV
        or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1)))
    if not ok:
        raise ImageFormatError(
            f"{name}: BMP with {bpp} bits a pixel, compression {comp} is not "
            f"supported")
    top_down = h < 0
    h = abs(h)
    kind = bpp
    if bpp == 16:
        kind = 15
        if comp == 3:
            r, g, b = struct.unpack("<III", data[14 + dib:26 + dib])
            if (r, g, b) == (0xF800, 0x07E0, 0x001F):
                kind = 16
            elif (r, g, b) != (0x7C00, 0x03E0, 0x001F):
                raise ImageFormatError(f"{name}: BMP bit fields "
                                       f"{r:#x} {g:#x} {b:#x} not supported")
    pal = None
    if bpp <= 8:
        if ncolors > 256:
            raise ImageFormatError(f"{name}: BMP palette of {ncolors}")
        n = ncolors or 1 << bpp
        pal = np.zeros((256, 3), np.uint8)
        raw = np.frombuffer(data[14 + dib:14 + dib + entry * n], np.uint8)
        k = raw.size // entry
        pal[:k] = raw[:k * entry].reshape(-1, entry)[:, :3]
    if comp in (1, 2):
        rows = _rle_indices(data, offset, w, h, bpp, name)
    else:
        stride = ((w * bpp + 7) // 8 + 3) & ~3
        if offset + stride * h > len(data):
            raise ImageFormatError(f"{name}: truncated BMP data")
        raw = np.frombuffer(data, np.uint8, stride * h, offset).reshape(
            h, stride)
        if bpp <= 8:
            rows = _unpack_bits(raw, bpp, w)
        elif bpp == 16:
            t = raw[:, :2 * w].reshape(h, w, 2).astype(np.int64) @ np.array(
                [1, 256])
            if kind == 15:
                g = (t >> 2) & 0xF8
                r = (t >> 7) & 0xF8
            else:
                g = (t >> 3) & 0xFC
                r = (t >> 8) & 0xF8
            rows = np.stack([(t << 3) & 0xF8, g, r], -1).astype(np.uint8)
        else:
            rows = raw[:, :w * bpp // 8].reshape(h, w, bpp // 8)[..., :3]
    if not top_down:
        rows = rows[::-1]
    return rows, pal


def decode_bmp_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 grey of a BMP: OpenCV's rounding 14-bit weights on each
    pixel's colour (on the palette for palette images)."""
    px, pal = _bmp_pixels(data, name)
    if pal is None:
        return _bgr_to_gray_cv(px[..., 0], px[..., 1], px[..., 2])
    lut = _bgr_to_gray_cv(pal[:, 0], pal[:, 1], pal[:, 2])
    return lut[px]


def encode_bmp(img: np.ndarray) -> bytes:
    """8-bit BMP with a grey palette of an (H, W) uint8 array."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ImageFormatError(
            f"BMP encode takes (H, W) uint8, not {img.shape} {img.dtype}")
    h, w = img.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = img[::-1]
    pal = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    pal[:, 3] = 0
    offset = 14 + 40 + 1024
    size = offset + rows.size
    head = b"BM" + struct.pack("<IHHI", size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.size,
                       0, 0, 256, 256)
    return head + info + pal.tobytes() + rows.tobytes()


# --- by file ----------------------------------------------------------------

def _decode(data: bytes, name: str, rgb: bool) -> tuple[np.ndarray, int]:
    """(pixels, EXIF orientation) of a JPEG, PNG, BMP or TIFF file's bytes,
    told apart by their signature as OpenCV does: (H, W) grey, or with
    ``rgb`` (H, W, 3) RGB, not yet turned."""
    if data[:2] == b"\xff\xd8":
        img = decode_jpeg_rgb(data, name) if rgb else decode_jpeg_gray(
            data, name)
        return img, jpeg_orientation(data)
    if data[:8] == _PNG_SIG:
        if not rgb:
            return decode_png_gray(data, name), png_orientation(data)
        px = _png_pixels(data, name)
        img = (np.repeat(px[..., :1], 3, axis=2) if px.shape[2] <= 2
               else px[..., :3])
        return img, png_orientation(data)
    if data[:2] == b"BM":
        if not rgb:
            return decode_bmp_gray(data, name), 0
        px, pal = _bmp_pixels(data, name)
        return (px if pal is None else pal[px])[..., ::-1], 0
    if data[:4] in TIFF_SIGNATURES:
        img, tag = decode_tiff(data, name)
        if not rgb:
            img = _bgr_to_gray_cv(img[..., 2], img[..., 1], img[..., 0])
        return img, tag
    raise ImageFormatError(f"{name}: unknown image format")


def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 grey of a JPEG, PNG, BMP or TIFF file's bytes, turned by
    the orientation the file stores: ``cv2.imdecode(...,
    cv2.IMREAD_GRAYSCALE)``."""
    return apply_orientation(*_decode(data, name, rgb=False))


def read_gray(path: str | Path) -> np.ndarray:
    path = Path(path)
    return decode_gray(path.read_bytes(), str(path))


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a file's bytes, turned by its orientation:
    ``cv2.imdecode(..., cv2.IMREAD_COLOR)`` followed by ``COLOR_BGR2RGB``.
    Grey files repeat their grey in the three channels; colour keeps its
    samples (alpha dropped, 16 bits cut to 8)."""
    return np.ascontiguousarray(
        apply_orientation(*_decode(data, name, rgb=True)))


def read_rgb(path: str | Path) -> np.ndarray:
    path = Path(path)
    return decode_rgb(path.read_bytes(), str(path))


_ENCODERS = {".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".png": encode_png,
             ".bmp": encode_bmp, ".tif": encode_tiff, ".tiff": encode_tiff}


def encode_for(path: str | Path, img: np.ndarray) -> bytes:
    """The bytes of ``img`` in the format ``path``'s suffix names."""
    enc = _ENCODERS.get(Path(path).suffix.lower())
    if enc is None:
        raise ImageFormatError(
            f"{path}: cannot write {Path(path).suffix or 'no'} files "
            f"(JPEG, PNG, BMP, TIFF only)")
    return enc(img)
