"""Progressive JPEG scans (SOF2, Huffman-coded), as libjpeg's
``jdphuff.c`` decodes them: DC first and refinement scans, interleaved or
not; AC first scans with end-of-band runs; AC refinement scans with their
correction bits; restart markers inside any of them. The coefficients go
into the frame's arrays; the inverse DCT and the colour stages are the
baseline decoder's, so a complete progressive file gives the pixels of the
baseline file with the same coefficients.

The scans are walked one symbol at a time in Python (an end-of-band run
spans blocks, and a refinement scan's correction bits depend on the
coefficients already decoded, so the baseline decoder's vectorised walk
does not carry over). A scan that ends before its last block raises
``ImageFormatError``: libjpeg would show such a file with its missing
coefficients smoothed (``jdcoefct.c``, ``decompress_smooth_data``).
"""

from __future__ import annotations

import numpy as np

from .codec_base import ZIGZAG, ImageFormatError, bit_windows

# natural index of each zigzag position; corrupt runs past 63 land on 63,
# as libjpeg's padded ``jpeg_natural_order`` has them
_NAT = ZIGZAG.tolist() + [63] * 16


def _lists(lut):
    """A Huffman table's length and symbol per 16-bit window as lists."""
    if not hasattr(lut, "lists"):
        lut.lists = (lut.length.tolist(), lut.sym.tolist())
    return lut.lists


def decode_progressive_scan(fr, scan, spectral, segments) -> None:
    ss, se, ah, al = spectral
    if ss == 0:
        if se != 0:
            raise ImageFormatError("progressive DC scan with AC terms")
    elif len(scan) != 1 or se < ss or se > 63:
        raise ImageFormatError("bad progressive AC scan")
    if ah and ah - 1 != al:
        raise ImageFormatError("bad successive approximation")
    n_mcu, pattern, grid = fr.mcu_layout(scan)
    for ci, _, _ in scan:
        bits = fr.coef_bits.setdefault(ci, [-1] * 64)
        for k in range(ss, se + 1):
            bits[k] = al
    seg_bytes = [np.frombuffer(s, np.uint8) for s in segments]
    seg_start = np.cumsum([0] + [8 * len(s) for s in seg_bytes]).tolist()
    stream = np.concatenate(seg_bytes) if seg_bytes else np.zeros(0, np.uint8)
    npos = 8 * len(stream)
    # zeros past the end, for a block that runs over a truncated scan's
    # end before the check after each block catches it
    win = bit_windows(stream, npos + 1).tolist() + [0] * 4096
    seg_end = seg_start[1:]

    # where each block of the MCU pattern sits in its component's flat
    # coefficient list
    coefs = {ci: fr.coef[ci].reshape(-1).tolist() for ci, _, _ in scan}
    gx = {ci: fr.coef[ci].shape[1] for ci, _, _ in scan}
    if len(scan) == 1:
        ci = scan[0][0]
        bw = grid[1]
        order = [(ci, ((b // bw) * gx[ci] + b % bw) * 64)
                 for b in range(n_mcu)]
        per_mcu = 1
    else:
        mx = grid[1]
        order = []
        for m in range(n_mcu):
            my_, mx_ = divmod(m, mx)
            for ci, _, _ in scan:
                _, ch, cv, _ = fr.comps[ci]
                for yy in range(cv):
                    for xx in range(ch):
                        order.append((ci, ((my_ * cv + yy) * gx[ci]
                                           + mx_ * ch + xx) * 64))
        per_mcu = len(pattern)

    ri = fr.restart
    if ss == 0:
        tables = {}
        if not ah:
            for ci, td, _ in scan:
                if td not in fr.dc:
                    raise ImageFormatError(
                        "scan uses an undefined Huffman table")
                tables[ci] = _lists(fr.dc[td])
        _dc_scan(win, order, per_mcu, n_mcu, ri, seg_start, seg_end, coefs,
                 tables, ah, al)
    else:
        ta = scan[0][2]
        if ta not in fr.ac:
            raise ImageFormatError("scan uses an undefined Huffman table")
        length, sym = _lists(fr.ac[ta])
        step = _ac_refine if ah else _ac_first
        step(win, order, ri, seg_start, seg_end, coefs[scan[0][0]],
             length, sym, ss, se, al)
    for ci in coefs:
        fr.coef[ci][:] = np.asarray(coefs[ci], np.int32).reshape(
            fr.coef[ci].shape)


def check_complete(fr) -> None:
    """Raise unless every wanted component's coefficients were refined to
    their last bit: libjpeg shows an incomplete progressive file with its
    missing coefficients smoothed (``decompress_smooth_data``), which the
    port does not reproduce."""
    for ci in fr.coef:
        if fr.wanted(ci) and any(b != 0 for b in fr.coef_bits.get(ci, [-1])):
            raise ImageFormatError(
                "incomplete progressive JPEG (its scans stop before every "
                "coefficient is whole) is not supported")


def _restart(seg, seg_start):
    """The next segment after a restart marker, and its first bit."""
    seg += 1
    if seg >= len(seg_start) - 1:
        raise ImageFormatError("missing restart marker")
    return seg, seg_start[seg]


def _dc_scan(win, order, per_mcu, n_mcu, ri, seg_start, seg_end, coefs,
             tables, ah, al):
    pos, seg = 0, 0
    pred = {ci: 0 for ci in coefs}
    b = 0
    for m in range(n_mcu):
        if ri and m and m % ri == 0:
            seg, pos = _restart(seg, seg_start)
            pred = {ci: 0 for ci in coefs}
        for _ in range(per_mcu):
            ci, base = order[b]
            b += 1
            if ah:                              # refinement: one bit
                if win[pos] >> 15:
                    coefs[ci][base] |= 1 << al
                pos += 1
            else:
                length, sym = tables[ci]
                w = win[pos]
                n = length[w]
                s = sym[w]
                if not n or s > 11:
                    raise ImageFormatError("bad Huffman code in JPEG scan")
                pos += n
                diff = 0
                if s:
                    v = win[pos] >> (16 - s)
                    diff = v if v >> (s - 1) else v - (1 << s) + 1
                    pos += s
                pred[ci] += diff
                coefs[ci][base] = pred[ci] * (1 << al)
        if pos > seg_end[seg]:
            raise ImageFormatError("truncated progressive JPEG scan")


def _ac_first(win, order, ri, seg_start, seg_end, coef, length, sym, ss, se,
              al):
    pos, seg, eobrun = 0, 0, 0
    nat = _NAT
    scale = 1 << al
    for b, (_, base) in enumerate(order):
        if ri and b and b % ri == 0:
            seg, pos = _restart(seg, seg_start)
            eobrun = 0
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            w = win[pos]
            n = length[w]
            if not n:
                raise ImageFormatError("bad Huffman code in JPEG scan")
            s = sym[w]
            pos += n
            r = s >> 4
            s &= 15
            if s:
                k += r
                v = win[pos] >> (16 - s)
                pos += s
                coef[base + nat[k]] = (v if v >> (s - 1)
                                       else v - (1 << s) + 1) * scale
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += win[pos] >> (16 - r)
                    pos += r
                eobrun -= 1
                break
            k += 1
        if pos > seg_end[seg]:
            raise ImageFormatError("truncated progressive JPEG scan")


def _ac_refine(win, order, ri, seg_start, seg_end, coef, length, sym, ss, se,
               al):
    pos, seg, eobrun = 0, 0, 0
    nat = _NAT
    p1, m1 = 1 << al, -1 << al
    for b, (_, base) in enumerate(order):
        if ri and b and b % ri == 0:
            seg, pos = _restart(seg, seg_start)
            eobrun = 0
        k = ss
        if not eobrun:
            while k <= se:
                w = win[pos]
                n = length[w]
                if not n:
                    raise ImageFormatError("bad Huffman code in JPEG scan")
                s = sym[w]
                pos += n
                r = s >> 4
                s &= 15
                if s:
                    s = p1 if win[pos] >> 15 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += win[pos] >> (16 - r)
                        pos += r
                    break
                # step over nonzero coefficients (a correction bit each)
                # and r zero ones; the new coefficient takes the next zero
                while k <= se:
                    i = base + nat[k]
                    c = coef[i]
                    if c:
                        if win[pos] >> 15 and not c & p1:
                            coef[i] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if s:
                    coef[base + nat[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = base + nat[k]
                c = coef[i]
                if c:
                    if win[pos] >> 15 and not c & p1:
                        coef[i] = c + p1 if c >= 0 else c + m1
                    pos += 1
                k += 1
            eobrun -= 1
        if pos > seg_end[seg]:
            raise ImageFormatError("truncated progressive JPEG scan")
