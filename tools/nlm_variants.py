#!/usr/bin/env python3
"""Times compile-time variants of kernel E (non-local means) on one GPU.

    python3 tools/nlm_variants.py

Each variant is the shipped ``csrc/nlm.cu`` with a few text substitutions
(tile constants, launch bounds, how values are rounded to bf16), built on its own with
nvcc into ``build/nlm_variants/`` and loaded with ctypes. Every variant runs
on the same random batch of 128 images of 320x256 in bf16 precision, must
equal the shipped kernel bit for bit, and is timed with CUDA events in
turns (shipped, variants, shipped). Prints ptxas's register line and the
ms per call of each; a variant that is faster and bit-equal is a candidate
for the source.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "multimodal_biometric_fingerprints_palms_tpu_torch" / "csrc" / "nlm.cu"
OUT = ROOT / "build" / "nlm_variants"

PACKED = ("    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);\n"
          "    a = __low2float(p);\n    b = __high2float(p);\n")
# one conversion per value, as the generic body rounds
SCALAR = [(PACKED, "    a = rnd<true>(a);\n    b = rnd<true>(b);\n")]
# round to nearest even on the float's bits (finite values only)
INTEGER = [(PACKED,
            "    unsigned ua = __float_as_uint(a), ub = __float_as_uint(b);\n"
            "    ua = (ua + 0x7FFFu + ((ua >> 16) & 1u)) & 0xFFFF0000u;\n"
            "    ub = (ub + 0x7FFFu + ((ub >> 16) & 1u)) & 0xFFFF0000u;\n"
            "    a = __uint_as_float(ua);\n    b = __uint_as_float(ub);\n")]
C8 = [("constexpr int kC = 16;", "constexpr int kC = 8;")]
B3 = [("__launch_bounds__(kStripThreads, 2)",
       "__launch_bounds__(kStripThreads, 3)")]

VARIANTS = {
    "shipped": [],
    "one conversion per value": SCALAR,
    "integer rounding": INTEGER,
    "8 outputs a step-3 task": C8,
    "8 outputs, one conversion per value": C8 + SCALAR,
    "3 blocks an SM": B3,
    "3 blocks an SM, 8 outputs": B3 + C8,
    "8 vertical sums a task, 576 threads": [
        ("constexpr int kSeg = 16;", "constexpr int kSeg = 8;"),
        ("constexpr int kStripThreads = 288;",
         "constexpr int kStripThreads = 576;"),
        ("__launch_bounds__(kStripThreads, 2)",
         "__launch_bounds__(kStripThreads, 1)")],
}


def build(name: str, subs) -> tuple[ctypes.CDLL, str]:
    text = SRC.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: '{old}' not in {SRC.name}")
        text = text.replace(old, new)
    stem = "nlm_" + "".join(c if c.isalnum() else "_" for c in name)
    cu, so = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    cu.write_text(text)
    res = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode",
         "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)],
        capture_output=True, text=True, check=False)
    if res.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{res.stdout}\n{res.stderr}")
    lines = (res.stdout + res.stderr).splitlines()
    regs = [later.strip() for i, line in enumerate(lines)
            if "Compiling" in line and "nlm_strip_kernelILb1" in line
            for later in lines[i + 1:i + 4]
            if "Used" in later or "spill" in later]
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mbfp_nlm.argtypes = [P, P, I, I, I, I, I, F, I, P]
    lib.mbfp_nlm.restype = I
    return lib, "; ".join(regs)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("nlm_variants: needs a GPU")
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.rand((128, 320, 256), generator=g).cuda()
    inv = -1.0 / ((10.0 / 255.0) ** 2) / 49.0
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib, out):
        rc = lib.mbfp_nlm(x.data_ptr(), out.data_ptr(), 128, 320, 256, 7, 21,
                          inv, 1, stream)
        if rc:
            raise SystemExit(f"mbfp_nlm: CUDA error {rc}")

    def time_ms(lib, out, reps=5):
        run(lib, out)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            run(lib, out)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    libs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    ref = torch.empty_like(x)
    run(libs["shipped"][0], ref)
    torch.cuda.synchronize()
    order = list(libs) + ["shipped"]
    for name in order:
        lib, regs = libs[name]
        out = torch.empty_like(x)
        ms = time_ms(lib, out)
        differ = int((out != ref).sum())
        print(f"{name}: {ms:.4f} ms, pixels that differ from the shipped "
              f"kernel {differ}; ptxas: {regs}")


if __name__ == "__main__":
    sys.exit(main())
