"""Builds the port's CUDA kernels into one shared library and loads it.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a plain-C-interface ``.so`` on first use, then bound with
``ctypes`` (pointers and the stream as ``c_void_p``). The library lands in
``build/torch_kernels/`` at the root of the checkout (git-ignored), named by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is compiled or loaded at import time.

``LAUNCHES`` counts wrapper launches per kernel; each wrapper adds one where
it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# Every kernel source of the port; each is compiled into the one library.
SOURCES = ("clahe.cu", "cc.cu", "thin.cu", "match.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"clahe": 0, "cc": 0, "thin": 0, "match": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (all return an int cudaError_t).
_SIGNATURES = {
    # img, lut, out, nb, h, w, grid, limit, scale, stream
    "mbfp_clahe": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    # mask, invert, label, nb, h, w, conn, stream
    "mbfp_cc_label": (_P, _I, _P, _I, _I, _I, _I, _P),
    # mask, marker, out, label, table, key, nb, h, w, conn, mode,
    # min_size, max_size, stream
    "mbfp_cc_filter": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _P),
    # mask, out, nb, h, w, max_iters, prune, stream
    "mbfp_zs_thin": (_P, _P, _I, _I, _I, _I, _I, _P),
    # fa, fb, hyp, possible, scores, counts, p, h, k, dist2, orient,
    # sigma_d2, sigma_o2, use_type, min_inliers, stream
    "mbfp_hypothesis_scores": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                               _F, _F, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the last compile, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmbfp_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC_DIR / s) for s in SOURCES]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    tmp.replace(so)
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def current_stream(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
