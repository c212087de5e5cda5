"""The port's image codec, in numpy and ``zlib`` only: what OpenCV does for
the JAX package's file runners.

- JPEG decode: baseline sequential JPEG (SOF0/SOF1, 8-bit), 1 or 3 (YCbCr)
  components with any sampling factors, interleaved or not, restart
  markers. Only the luma component becomes pixels, as
  ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives it, through libjpeg's
  integer ``JDCT_ISLOW`` inverse DCT, so the pixels equal OpenCV's bit for
  bit.
- JPEG encode: 1 component (grey) or 3 (an (H, W, 3) array in OpenCV's BGR
  order, coded YCbCr 4:4:4), the IJG tables scaled to the quality (95, as
  ``cv2.imwrite``), the standard Huffman tables, libjpeg's integer
  ``JDCT_ISLOW`` forward DCT, quantization and colour conversion: the file
  is byte-equal to ``cv2.imwrite``'s (for colour, with 4:4:4 sampling).
- PNG: read 8-bit grey, grey + alpha, RGB and RGBA, non-interlaced, all five
  filters; write 8-bit grey and RGB (BGR order in, as OpenCV).
- BMP: read 8-bit paletted and 24-bit uncompressed; write 8-bit grey.

Colour becomes grey as OpenCV's reader of each format makes it: the luma
plane for JPEG, libpng's truncating 15-bit weights for PNG, OpenCV's
rounding 14-bit weights for BMP.

Everything else (progressive or arithmetic-coded JPEG, TIFF, other
formats) raises ``ImageFormatError`` naming the file and the format.

The Huffman decoder runs vectorised over every bit position of the scan:
where the AC symbol that would start there ends, and where the symbol
after it ends (pointer doubling), so that the walk from one block to the
next takes a lookup per two symbols in Python; the coefficients are then
read for all blocks at once (no loop over coefficients).
"""

from __future__ import annotations

import functools
import struct
import zlib
from pathlib import Path

import numpy as np


class ImageFormatError(ValueError):
    """An image file the codec cannot read or write."""


# --- JPEG tables -----------------------------------------------------------

# zigzag position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

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
    0xC2: "progressive JPEG", 0xC3: "lossless JPEG",
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


def _windows(stream: np.ndarray, npos: int) -> np.ndarray:
    """The 16 bits starting at every bit position 0..npos+31 of ``stream``
    (zero bits past its end)."""
    nbytes = (npos + 47) // 8 + 1
    b = np.zeros(nbytes + 3, np.uint32)
    b[:min(len(stream), nbytes)] = stream[:nbytes]
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shifts = np.arange(8, 0, -1, dtype=np.uint32)
    win = (w24[:, None] >> shifts[None, :]) & 0xFFFF
    return win.reshape(-1)[:npos + 32].astype(np.intp)


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
    """What the markers before and between scans set up."""

    def __init__(self):
        self.qt: dict[int, np.ndarray] = {}
        self.dc: dict[int, _HuffLut] = {}
        self.ac: dict[int, _HuffLut] = {}
        self.restart = 0
        self.size = None            # (H, W)
        self.comps = []             # [(id, h, v, tq)]
        self.adobe_transform = None
        self.jfif = False
        self.y_coef = None          # (blocks_y, blocks_x, 64) int32
        self.y_tq = None            # the luma component's table


def _decode_scan(fr: _Frame, data: bytes, hdr: int, length: int) -> int:
    ns = data[hdr]
    if length != 6 + 2 * ns:
        raise ImageFormatError("bad SOS length")
    ids = [c[0] for c in fr.comps]
    scan = []
    for i in range(ns):
        cid, tables = data[hdr + 1 + 2 * i], data[hdr + 2 + 2 * i]
        if cid not in ids:
            raise ImageFormatError("scan names an unknown component")
        scan.append((ids.index(cid), tables >> 4, tables & 15))
    ss, se, a = data[hdr + 1 + 2 * ns:hdr + 4 + 2 * ns]
    if (ss, se, a) != (0, 63, 0):
        raise ImageFormatError("not a baseline sequential scan")
    segments, end = _scan_segments(data, hdr + length - 2)

    hmax = max(c[1] for c in fr.comps)
    vmax = max(c[2] for c in fr.comps)
    h, w = fr.size
    if len(scan) == 1:
        ci = scan[0][0]
        _, ch, cv, _ = fr.comps[ci]
        bw = -(-(-(-w * ch // hmax)) // 8)
        bh = -(-(-(-h * cv // vmax)) // 8)
        n_mcu, pattern = bw * bh, [scan[0]]
        grid = (bh, bw)
    else:
        mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        n_mcu = mx * my
        pattern = [s for s in scan for _ in range(fr.comps[s[0]][1]
                                                   * fr.comps[s[0]][2])]
        grid = (my, mx)
    if 0 not in [s[0] for s in scan]:
        return end                   # no luma in this scan: skip decoding
    for _, td, ta in scan:
        if td not in fr.dc or ta not in fr.ac:
            raise ImageFormatError("scan uses an undefined Huffman table")

    seg_bytes = [np.frombuffer(s, np.uint8) for s in segments]
    seg_start = np.cumsum([0] + [8 * len(s) for s in seg_bytes]).tolist()
    stream = np.concatenate(seg_bytes) if seg_bytes else np.zeros(0, np.uint8)
    npos = 8 * len(stream) + 1
    win = _windows(stream, npos)
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

    # luma blocks only from here on
    is_y = np.array([s[0] == 0 for s in pattern] * n_mcu)
    td_y, ta_y = next((td, ta) for ci, td, ta in pattern if ci == 0)
    s_y = np.asarray(starts)[is_y]
    seg_y = np.asarray(seg_of)[is_y]
    dl = fr.dc[td_y]
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
    al = fr.ac[ta_y]
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

    # place the blocks in the luma plane's block grid
    gy, gx = grid
    if len(scan) == 1:
        fr.y_coef = coef.reshape(gy, gx, 64)
    else:
        _, yh, yv, _ = fr.comps[0]
        fr.y_coef = coef.reshape(gy, gx, yv, yh, 64).transpose(
            0, 2, 1, 3, 4).reshape(gy * yv, gx * yh, 64)
    fr.y_tq = fr.comps[0][3]
    return end


def decode_jpeg_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 luma of a baseline JPEG, equal to OpenCV's
    ``IMREAD_GRAYSCALE``."""
    if data[:2] != b"\xff\xd8":
        raise ImageFormatError(f"{name}: not a JPEG file")
    fr = _Frame()
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
                f"{name}: {_SOF_NAMES[m]} is not supported (baseline only)")
        if m in (0xC0, 0xC1):
            if seg[0] != 8:
                raise ImageFormatError(
                    f"{name}: {seg[0]}-bit JPEG is not supported")
            h, w, nf = struct.unpack(">HHB", seg[1:6])
            if h == 0 or w == 0:
                raise ImageFormatError(f"{name}: JPEG without a frame size")
            if nf not in (1, 3):
                raise ImageFormatError(
                    f"{name}: JPEG with {nf} components is not supported")
            fr.size = (h, w)
            fr.comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                         seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                        for c in range(nf)]
            if any(not (1 <= c[1] <= 4 and 1 <= c[2] <= 4) for c in fr.comps):
                raise ImageFormatError(f"{name}: bad sampling factors")
            if (fr.comps[0][1] != max(c[1] for c in fr.comps)
                    or fr.comps[0][2] != max(c[2] for c in fr.comps)):
                raise ImageFormatError(
                    f"{name}: luma sampled below chroma is not supported")
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
            try:
                i = _decode_scan(fr, data, i + 2, length)
            except ImageFormatError as e:
                raise ImageFormatError(f"{name}: {e}") from None
            continue
        i += length
    if fr.y_coef is None:
        raise ImageFormatError(f"{name}: JPEG without image data")
    if len(fr.comps) == 3 and not _is_ycbcr(fr):
        raise ImageFormatError(
            f"{name}: RGB-coded 3-component JPEG is not supported")
    if fr.y_tq not in fr.qt:
        raise ImageFormatError(f"{name}: undefined quantization table")
    gy, gx, _ = fr.y_coef.shape
    px = _idct_islow(fr.y_coef.reshape(-1, 64), fr.qt[fr.y_tq])
    img = px.reshape(gy, gx, 8, 8).transpose(0, 2, 1, 3).reshape(gy * 8, gx * 8)
    h, w = fr.size
    return np.ascontiguousarray(img[:h, :w])


def _is_ycbcr(fr: _Frame) -> bool:
    """libjpeg's guess of a 3-component colour space (jdapimin.c)."""
    if fr.jfif:
        return True
    if fr.adobe_transform is not None:
        return fr.adobe_transform != 0
    return [c[0] for c in fr.comps] != [ord("R"), ord("G"), ord("B")]


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


def _png_pixels(data: bytes, name: str) -> np.ndarray:
    """(H, W, channels) uint8 samples of an 8-bit non-interlaced PNG."""
    if data[:8] != _PNG_SIG:
        raise ImageFormatError(f"{name}: not a PNG file")
    i, idat, hdr = 8, [], None
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        i += 12 + n
    if hdr is None:
        raise ImageFormatError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ImageFormatError(
            f"{name}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} is not supported (8-bit grey, grey + "
            f"alpha, RGB or RGBA, non-interlaced only)")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ImageFormatError(f"{name}: corrupt PNG data: {e}") from None
    if raw.size < h * (w * channels + 1):
        raise ImageFormatError(f"{name}: truncated PNG data")
    return _png_unfilter(raw[:h * (w * channels + 1)], h, w * channels,
                         channels).reshape(h, w, channels)


def decode_png_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 grey of an 8-bit PNG, as OpenCV's ``IMREAD_GRAYSCALE``
    gives it: libpng's ``rgb_to_gray`` with OpenCV's weights 0.299 and
    0.587 (29900 * 32768 // 100000 and 58700 * 32768 // 100000 of 32768,
    the rest blue), truncated, grey pixels kept; alpha dropped."""
    px = _png_pixels(data, name)
    channels = px.shape[2]
    if channels <= 2:
        return np.ascontiguousarray(px[..., 0])
    r, g, b = (px[..., c].astype(np.int64) for c in range(3))
    gray = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (r == b), r, gray).astype(np.uint8)


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


def _bmp_pixels(data: bytes, name: str):
    """(rows (H, W*3) BGR or (H, W) palette indices, palette (256, 3+) BGR
    or None, W) of an uncompressed 8-bit paletted or 24-bit BMP."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ImageFormatError(f"{name}: not a BMP file")
    offset, dib = struct.unpack("<II", data[10:18])
    if dib == 12:
        w, h, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp, ncolors, pal_entry = 0, 0, 3
    elif dib >= 40:
        w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        ncolors = struct.unpack("<I", data[46:50])[0]
        pal_entry = 4
    else:
        raise ImageFormatError(f"{name}: unknown BMP header size {dib}")
    if comp != 0 or bpp not in (8, 24):
        raise ImageFormatError(
            f"{name}: BMP with {bpp} bits a pixel, compression {comp} is not "
            f"supported (uncompressed 8 or 24 bits only)")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ImageFormatError(f"{name}: BMP of size {w}x{h}")
    stride = (w * bpp // 8 + 3) & ~3
    if offset + stride * h > len(data):
        raise ImageFormatError(f"{name}: truncated BMP data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 24:
        return rows[:, :3 * w].reshape(h, w, 3), None
    ncolors = ncolors or 256
    pal_at = 14 + dib
    pal = np.zeros((256, pal_entry), np.uint8)
    raw = np.frombuffer(data, np.uint8, min(ncolors, 256) * pal_entry, pal_at)
    pal[:min(ncolors, 256)] = raw.reshape(-1, pal_entry)
    return rows[:, :w], pal


def decode_bmp_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 grey of an uncompressed 8-bit paletted or 24-bit BMP."""
    px, pal = _bmp_pixels(data, name)
    if pal is None:
        return _bgr_to_gray_cv(px[..., 0], px[..., 1], px[..., 2])
    if (pal[:, 0] == pal[:, 1]).all() and (pal[:, 0] == pal[:, 2]).all():
        lut = pal[:, 0]
    else:
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

def decode_gray(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) uint8 grey of a JPEG, PNG or BMP file's bytes, told apart by
    their signature as OpenCV does."""
    if data[:2] == b"\xff\xd8":
        return decode_jpeg_gray(data, name)
    if data[:8] == _PNG_SIG:
        return decode_png_gray(data, name)
    if data[:2] == b"BM":
        return decode_bmp_gray(data, name)
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        raise ImageFormatError(f"{name}: TIFF is not supported")
    raise ImageFormatError(f"{name}: unknown image format")


def read_gray(path: str | Path) -> np.ndarray:
    path = Path(path)
    return decode_gray(path.read_bytes(), str(path))


def _jpeg_components(data: bytes, name: str) -> int:
    """The component count of a JPEG's frame header."""
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m == 0xFF or m == 0x01 or 0xD0 <= m <= 0xD8:
            i += 1 if m == 0xFF else 2
            continue
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return data[i + 9]
        i += 2 + length
    raise ImageFormatError(f"{name}: JPEG without a frame header")


def decode_rgb(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a file's bytes, as OpenCV's ``IMREAD_COLOR``
    followed by ``COLOR_BGR2RGB`` gives it: grey JPEGs, PNGs and BMPs
    repeat their grey in the three channels; colour PNGs and BMPs keep
    their samples (alpha dropped). A colour JPEG is refused: its chroma
    upsampling and colour conversion are not ported (``ROADMAP.md`` queue
    1, item 2)."""
    if data[:2] == b"\xff\xd8":
        if _jpeg_components(data, name) != 1:
            raise ImageFormatError(
                f"{name}: colour JPEG read as colour is not supported (grey "
                "JPEGs only; ROADMAP.md queue 1, item 2)")
        return np.repeat(decode_jpeg_gray(data, name)[..., None], 3, axis=2)
    if data[:8] == _PNG_SIG:
        px = _png_pixels(data, name)
        if px.shape[2] <= 2:
            return np.repeat(px[..., :1], 3, axis=2)
        return np.ascontiguousarray(px[..., :3])
    if data[:2] == b"BM":
        px, pal = _bmp_pixels(data, name)
        bgr = px if pal is None else pal[px][..., :3]
        return np.ascontiguousarray(bgr[..., ::-1])
    return np.repeat(decode_gray(data, name)[..., None], 3, axis=2)


def read_rgb(path: str | Path) -> np.ndarray:
    path = Path(path)
    return decode_rgb(path.read_bytes(), str(path))


_ENCODERS = {".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".png": encode_png,
             ".bmp": encode_bmp}


def encode_for(path: str | Path, img: np.ndarray) -> bytes:
    """The bytes of ``img`` in the format ``path``'s suffix names."""
    enc = _ENCODERS.get(Path(path).suffix.lower())
    if enc is None:
        raise ImageFormatError(
            f"{path}: cannot write {Path(path).suffix or 'no'} files "
            f"(JPEG, PNG, BMP only)")
    return enc(img)
