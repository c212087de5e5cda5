"""ctypes binding of the port to the repository's native batch image
loader, ``native/libmbfp_loader.so`` (a copy of the JAX package's binding).

``native/batch_loader.cpp`` decodes grayscale JPEG and BMP files through
libjpeg on a C++ thread pool into one padded uint8 (or float32 [0, 1])
batch. The library is
built with ``make -C native`` on first use where g++ and libjpeg's headers
are present; where they are not (the card's machine has no libjpeg),
``native_available()`` is false and callers read through ``image_codec``.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libmbfp_loader.so"
_lib = None
_build_failed = False


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if not _LIB_PATH.exists() or (_LIB_PATH.stat().st_mtime
                                      < (_NATIVE_DIR / "batch_loader.cpp").stat().st_mtime):
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(str(_LIB_PATH))
        for name, pixel in (("mbfp_batch_load", ctypes.c_float),
                            ("mbfp_batch_load_u8", ctypes.c_uint8)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(pixel), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _build_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def _load(fn, pixel, dtype, paths, out_h: int, out_w: int, num_threads: int):
    n = len(paths)
    batch = np.zeros((n, out_h, out_w), dtype=dtype)
    status = np.ones((n,), dtype=np.int32)
    widths = np.zeros((n,), dtype=np.int32)
    heights = np.zeros((n,), dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    fn(c_paths, n, batch.ctypes.data_as(ctypes.POINTER(pixel)), out_h, out_w,
       status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
       widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
       heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
       num_threads)
    return batch, status, widths, heights


def batch_load(paths, out_h: int, out_w: int, num_threads: int = 0):
    """Load images into a padded (N, H, W) float32 [0,1] batch.

    Returns (batch, status, widths, heights); status[i] == 0 on success.
    Raises RuntimeError if the native library is unavailable.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    return _load(lib.mbfp_batch_load, ctypes.c_float, np.float32, paths,
                 out_h, out_w, num_threads)


def batch_load_u8(paths, out_h: int, out_w: int, num_threads: int = 0):
    """Load images into a padded (N, H, W) uint8 batch; each image is
    decoded straight into its slot.

    Returns (batch, status, widths, heights); status[i] == 0 on success.
    Raises RuntimeError if the native library is unavailable.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    return _load(lib.mbfp_batch_load_u8, ctypes.c_uint8, np.uint8, paths,
                 out_h, out_w, num_threads)
