"""The orientation an image file stores (EXIF tag 274) and OpenCV's use of
it: ``cv2.imread`` / ``cv2.imdecode`` with ``IMREAD_GRAYSCALE`` or
``IMREAD_COLOR`` turn the decoded pixels by it.

The value is read where OpenCV's readers find it: in a JPEG, from the
first APP1 segment, which must start ``Exif\\0\\0``; in a PNG, from the
``eXIf`` chunk; in a TIFF, from tag 274 of the first directory. An Exif
block is a little TIFF (``II*\\0`` or ``MM\\0*``, then the offset of IFD0).
Its entries are read in order as OpenCV's ``ExifReader`` reads them: an
entry that runs past the block's end ends the walk, and entries read
before it count. The orientation is the 16-bit word at the entry's value
field whatever type the entry declares. Values outside 1..8 turn nothing.
"""

from __future__ import annotations

import struct

import numpy as np

ORIENTATION_TAG = 0x0112


def exif_orientation(block: bytes) -> int:
    """The orientation in a TIFF-structured Exif block (no ``Exif\\0\\0``
    prefix), 0 where it holds none or cannot be read."""
    if len(block) < 8 or block[:2] not in (b"II", b"MM"):
        return 0
    bo = "<" if block[:2] == b"II" else ">"
    if struct.unpack(bo + "H", block[2:4])[0] != 42:
        return 0
    ifd = struct.unpack(bo + "I", block[4:8])[0]
    if ifd + 2 > len(block):
        return 0
    n = struct.unpack(bo + "H", block[ifd:ifd + 2])[0]
    found = 0
    for k in range(n):
        e = ifd + 2 + 12 * k
        if e + 2 > len(block):
            break
        tag = struct.unpack(bo + "H", block[e:e + 2])[0]
        if tag == ORIENTATION_TAG:
            if e + 10 > len(block):
                break
            found = struct.unpack(bo + "H", block[e + 8:e + 10])[0]
        elif e + 12 > len(block):
            break
    return found


def jpeg_orientation(data: bytes) -> int:
    """The orientation of a JPEG file: the first APP1 segment's Exif block.
    A walk over the marker segments before the first scan."""
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            return 0
        m = data[i + 1]
        if m == 0xFF:
            i += 1
            continue
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m in (0xDA, 0xD9):
            return 0
        length = struct.unpack(">H", data[i + 2:i + 4])[0]
        if m == 0xE1:
            seg = data[i + 4:i + 2 + length]
            return exif_orientation(seg[6:]) if seg[:6] == b"Exif\x00\x00" else 0
        i += 2 + length
    return 0


def png_orientation(data: bytes) -> int:
    """The orientation of a PNG file's ``eXIf`` chunk."""
    i = 8
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        if kind == b"eXIf":
            return exif_orientation(data[i + 8:i + 8 + n])
        if kind == b"IEND":
            break
        i += 12 + n
    return 0


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` (H, W, ...) turned as OpenCV's ``ExifTransform`` turns it for
    the EXIF orientation value: 2 mirrors left-right, 3 turns by 180
    degrees, 4 mirrors top-bottom, 5 transposes, 6 turns a quarter
    clockwise, 7 transposes across the other diagonal, 8 turns a quarter
    anticlockwise; any other value returns ``img``."""
    if orientation == 2:
        out = img[:, ::-1]
    elif orientation == 3:
        out = img[::-1, ::-1]
    elif orientation == 4:
        out = img[::-1]
    elif orientation == 5:
        out = img.swapaxes(0, 1)
    elif orientation == 6:
        out = img[::-1].swapaxes(0, 1)
    elif orientation == 7:
        out = img[::-1, ::-1].swapaxes(0, 1)
    elif orientation == 8:
        out = img[:, ::-1].swapaxes(0, 1)
    else:
        return img
    return np.ascontiguousarray(out)
