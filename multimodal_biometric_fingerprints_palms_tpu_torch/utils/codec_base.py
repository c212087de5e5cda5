"""What the image codec's modules share: the error they raise, JPEG's
zigzag order and the bit windows both JPEG decoders walk. Imports nothing
of the package, so ``image_codec``, ``jpeg_progressive`` and ``tiff`` all
import it at their top."""

from __future__ import annotations

import numpy as np


class ImageFormatError(ValueError):
    """An image file the codec cannot read or write."""


# zigzag position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def bit_windows(stream: np.ndarray, npos: int) -> np.ndarray:
    """The 16 bits starting at every bit position 0..npos+31 of ``stream``
    (zero bits past its end)."""
    nbytes = (npos + 47) // 8 + 1
    b = np.zeros(nbytes + 3, np.uint32)
    b[:min(len(stream), nbytes)] = stream[:nbytes]
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shifts = np.arange(8, 0, -1, dtype=np.uint32)
    win = (w24[:, None] >> shifts[None, :]) & 0xFFFF
    return win.reshape(-1)[:npos + 32].astype(np.intp)
