"""Builds the port's CUDA kernels into one shared library and loads it.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc -c`` per source and all started together, linked
into a plain-C-interface ``.so`` on first use, then bound with ``ctypes``
(pointers and the stream as ``c_void_p``). The library lands in
``build/torch_kernels/`` at the root of the checkout (git-ignored), named by
a hash of the sources, their headers and the flags, so an edited source or
header rebuilds and an unchanged one loads at once. Nothing is compiled or
loaded at import time.

Each wrapper counts its launches in ``utils.profiling``'s registry as
``kernel.<name>`` (``KERNELS``), where it launches its kernel and nowhere
else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils.profiling import COUNTERS, reset

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# Every kernel source of the port; each is compiled into the one library.
SOURCES = ("clahe.cu", "cc.cu", "thin.cu", "match.cu", "nlm.cu",
           "binarize.cu", "morph.cu")
# Headers the sources include; they are part of the library's hash.
HEADERS = ("packed_words.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

KERNELS = ("clahe", "cc", "thin", "match", "nlm", "binarize", "morph")
for _kernel in KERNELS:
    COUNTERS.setdefault(f"kernel.{_kernel}", 0)


def launches() -> dict:
    """Each kernel's launches so far, by kernel name."""
    return {k: COUNTERS[f"kernel.{k}"] for k in KERNELS}


def reset_launches() -> None:
    reset("kernel.")

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
    # mask, out, scratch, nb, h, w, max_iters, prune, form, stream
    "mbfp_zs_thin": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # nb, h, w, form, &bytes (long long)
    "mbfp_zs_thin_scratch": (_I, _I, _I, _I, _P),
    # xy, orientation, type, valid, weight of A and of B; theta, t,
    # has_cand, possible; scores, counts; p, h, k, dist2, orient, sigma_d2,
    # sigma_o2, use_type, min_inliers, stream
    "mbfp_hypothesis_scores": (*(_P,) * 16, _I, _I, _I, _F, _F, _F, _F, _I,
                               _I, _P),
    # img, out, nb, h, w, template, search, inv, bf16, stream
    "mbfp_nlm": (_P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    # img, mean, std, stdmax, out, nb, h, w, win, tap, k, otsu, stream
    "mbfp_binarize_front": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I,
                            _P),
    # mask, out, nb, h, w, stream
    "mbfp_open_erode_reconstruct": (_P, _P, _I, _I, _I, _P),
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
    for name in SOURCES + HEADERS:
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
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / s), "-o", str(o)]
            for s, o in zip(SOURCES, objs)]
    tmp = BUILD_DIR / f"{tag}.tmp"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(c, **pipes) for c in cmds]
        steps = [(c, p.communicate()[0], p.returncode)
                 for c, p in zip(cmds, procs)]
        if not any(rc for _, _, rc in steps):
            res = subprocess.run(link, **pipes)
            steps.append((link, res.stdout, res.returncode))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(
        "".join(" ".join(c) + "\n" + out for c, out, _ in steps))
    failed = [" ".join(c) + "\n" + out for c, out, rc in steps if rc]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
