"""CCITT bilevel coding in TIFF, as libtiff's ``tif_fax3.c`` decodes it for
OpenCV's TIFF reader: Modified Huffman RLE (compression 2), Group 3
(compression 3, T.4: 1-D, or 2-D where the T4Options tag 292 sets bit 0)
and Group 4 (compression 4, T.6).

- RLE: each row's runs in Modified Huffman codes, the row padded to a
  byte; no EOLs.
- Group 3: each row after an EOL (eleven or more zero bits, then a one;
  T4Options bit 2 pads the zeros so that the EOL ends on a byte), then with
  2-D coding one tag bit: 1 for a Modified Huffman row, 0 for a 2-D row
  against the row above. The RTC after the last row is not read.
- Group 4: every row 2-D, the first against an imaginary white row; no
  EOLs.

A row's runs alternate white and black, white first; a run is any number
of make-up codes and one terminating code. The 2-D modes (pass,
horizontal, vertical by -3 to +3) are T.4's. Rows come back packed, MSB
first, 1 for a black run, as libtiff gives them before the photometric
interpretation; each strip starts against a white row. The bit order is
the caller's: a fill order of 2 reverses each byte first.

The walk goes one code at a time in Python, a whole run a step, over a
table of the 13-bit window at the code's first bit; the rows are then
painted from their changing elements with numpy. Uncompressed mode (the
2-D extension code) raises ``ImageFormatError``, as libtiff refuses it;
so does a code that fits no table.
"""

from __future__ import annotations

import functools

import numpy as np

from .codec_base import ImageFormatError, bit_windows

# T.4 Tables 2 and 3: terminating codes for runs 0..63, then make-up codes
# for runs 64..1728 in steps of 64
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
# T.4 Table 3a: make-up codes for runs 1792..2560, either colour
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111")
# T.4 Table 4: the 2-D modes (vertical offsets -3..3 as 'V' + offset)
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2,
          "0000011": 3, "010": -1, "000010": -2, "0000010": -3}

_BITS = 13                      # the longest code (a black make-up code)
_EOL_ZEROS = "0" * 11


def _run_table(term: str, makeup: str) -> tuple[list, list]:
    """(code length, run) for each 13-bit window; length 0 where no code
    starts the window. Runs of 64 and more are make-up codes."""
    length = [0] * (1 << _BITS)
    run = [0] * (1 << _BITS)
    codes = [(c, r) for r, c in enumerate(term.split())]
    codes += [(c, 64 * (k + 1)) for k, c in enumerate(makeup.split())]
    codes += [(c, 1792 + 64 * k) for k, c in enumerate(_EXT_MAKEUP.split())]
    for code, r in codes:
        n = len(code)
        lo = int(code, 2) << (_BITS - n)
        for w in range(lo, lo + (1 << (_BITS - n))):
            if length[w]:
                raise AssertionError(f"codes overlap at {code}")
            length[w], run[w] = n, r
    return length, run


def _mode_table() -> tuple[list, list]:
    length = [0] * 128
    mode = [None] * 128
    for code, m in _MODES.items():
        n = len(code)
        lo = int(code, 2) << (7 - n)
        for w in range(lo, lo + (1 << (7 - n))):
            length[w], mode[w] = n, m
    return length, mode


@functools.cache
def _tables():
    """((white, black) run tables, the mode table), built on first use."""
    return ((_run_table(_WHITE_TERM, _WHITE_MAKEUP),
             _run_table(_BLACK_TERM, _BLACK_MAKEUP)), _mode_table())


class _Bits:
    """A strip's bits: the 16-bit window at every bit position, and the
    bits as a string for finding EOLs."""

    def __init__(self, data: bytes):
        stream = np.frombuffer(data, np.uint8)
        self.n = 8 * len(data)
        self.win = bit_windows(stream, self.n).tolist()
        self.text = np.unpackbits(stream).tobytes().translate(
            bytes.maketrans(b"\x00\x01", b"01")).decode("ascii")
        self.pos = 0

    def peek(self, nbits: int) -> int:
        if self.pos >= self.n:
            raise ImageFormatError("CCITT data ends inside a row")
        return self.win[self.pos] >> (16 - nbits)

    def sync_eol(self) -> bool:
        """Skip to just after the next EOL, as libtiff's ``SYNC_EOL``;
        False where none is left."""
        z = self.text.find(_EOL_ZEROS, self.pos)
        if z < 0:
            return False
        one = self.text.find("1", z + 11)
        if one < 0:
            return False
        self.pos = one + 1
        return True


def _run(bits: _Bits, table) -> int:
    """One run: make-up codes until a terminating code."""
    length, run = table
    total = 0
    while True:
        w = bits.peek(_BITS)
        n = length[w]
        if not n:
            raise ImageFormatError("bad CCITT run code")
        bits.pos += n
        r = run[w]
        total += r
        if r < 64:
            return total


def _row_1d(bits: _Bits, width: int, runs) -> list[int]:
    """The changing elements of a Modified Huffman row."""
    changes, x, colour = [], 0, 0
    while x < width:
        x = min(x + _run(bits, runs[colour]), width)
        changes.append(x)
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, width: int, ref: list[int], runs,
            modes) -> list[int]:
    """The changing elements of a 2-D row against ``ref``'s (T.4 4.2):
    pass, horizontal and vertical modes from a0 to the row's end."""
    mlen, mode = modes
    ref = ref + [width] * 3
    changes = []
    a0, colour, i = -1, 0, 0
    while a0 < width:
        # b1: the first changing element right of a0 of the other colour
        # (element k makes the pixel black where k is even); a0 never
        # moves left, so neither does i, the first element right of it
        while ref[i] <= a0 and i < len(ref) - 3:
            i += 1
        k = i if i % 2 == colour else i + 1
        b1, b2 = ref[k], ref[k + 1]
        w = bits.peek(7)
        n = mlen[w]
        if not n:
            raise ImageFormatError("CCITT uncompressed mode or a misplaced "
                                   "EOL is not supported")
        bits.pos += n
        m = mode[w]
        if m == "P":
            a0 = b2
        elif m == "H":
            a1 = min(max(a0, 0) + _run(bits, runs[colour]), width)
            a2 = min(a1 + _run(bits, runs[colour ^ 1]), width)
            changes += [a1, a2]
            a0 = a2
        else:
            a0 = min(max(b1 + m, 0), width)
            changes.append(a0)
            colour ^= 1
    return changes


def _pixel_changes(changes: list[int], width: int) -> list[int]:
    """The row's changing elements as its pixels have them: positions below
    the width, a run of no pixels cancelling its neighbour."""
    out: list[int] = []
    for c in changes:
        if c >= width:
            break
        if out and out[-1] == c:
            out.pop()
        else:
            out.append(c)
    return out


def decode_ccitt(data: bytes, compression: int, width: int, rows: int,
                 t4_options: int = 0) -> bytes:
    """``rows`` rows of ``width`` bilevel pixels, packed MSB first and
    padded to bytes (1 for black runs), of one strip or tile coded with
    TIFF compression 2, 3 or 4."""
    runs, modes = _tables()
    bits = _Bits(data)
    ref: list[int] = []
    every: list[list[int]] = []
    two_d = compression == 3 and t4_options & 1
    if compression == 3 and t4_options & 2:
        raise ImageFormatError("CCITT Group 3 with uncompressed mode is not "
                               "supported")
    for _ in range(rows):
        if compression == 2:
            changes = _row_1d(bits, width, runs)
            bits.pos = -(-bits.pos // 8) * 8
        elif compression == 3:
            if not bits.sync_eol():
                raise ImageFormatError("CCITT Group 3 row without an EOL")
            if two_d:
                tag = bits.peek(1)
                bits.pos += 1
                changes = (_row_1d(bits, width, runs) if tag else
                           _row_2d(bits, width, ref, runs, modes))
            else:
                changes = _row_1d(bits, width, runs)
        else:
            changes = _row_2d(bits, width, ref, runs, modes)
        ref = _pixel_changes(changes, width)
        every.append(ref)
    # paint: each changing element flips the colour from there on
    flips = np.zeros((rows, width + 1), np.uint8)
    for y, ch in enumerate(every):
        flips[y, ch] = 1
    px = np.bitwise_xor.accumulate(flips[:, :width], axis=1)
    return np.packbits(px, axis=1).tobytes()
