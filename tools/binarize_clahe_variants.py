#!/usr/bin/env python3
"""Holds kernels F (Sauvola + patch-Otsu binarize front) and A (CLAHE) to
the kernels they replaced, and times compile-time variants of both, on one
GPU.

    python3 tools/binarize_clahe_variants.py

Builds with nvcc into ``build/binarize_clahe_variants/``: the two parent
sources (``tools/binarize_parent.cu``: 32x32 tiles, the box means taken in
both launches, the Otsu half per 1,024-thread block;
``tools/clahe_parent.cu``: a serial LUT tail, float LUTs in device memory, a
thread a pixel), the shipped ``csrc/binarize.cu`` and ``csrc/clahe.cu``, and
the shipped sources with a few text substitutions each (F: outputs a thread
forms along the filtered axis, width of a block's region, blocks an SM,
warps a patch, and diagnostics that drop a part to time it; A: the four LUT
taps as one packed word a bin instead of four bytes, histograms a block,
rows a batch), and ``tools/binarize_cluster.cu`` (F in one launch by a
thread-block cluster an image, mean and std kept in shared memory; taken
for frames of whole patches up to 512 x 512).

Inputs: the main path's own (``make_batch(128)`` through
``preprocess_fingerprint``: the three CLAHE inputs with their clip limits,
and the equalized image the binarize stage thresholds), and random frames
that are ragged, tiny, odd-tiled or 1024 x 1024. For every library it
prints the values (pixels, and A's LUT entries) that differ from the parent
kernel and from the shipped kernel over all cases (both must be 0, except
for a variant named a diagnostic, which is wrong on purpose to time a part) and ms per call by CUDA events at
(128, 320, 256), taken in turns (parent, shipped, variants, shipped,
parent), with the card's name and power limit. Exits 1 on any difference.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "multimodal_biometric_fingerprints_palms_tpu_torch"
CSRC = ROOT / PKG / "csrc"
OUT = ROOT / "build" / "binarize_clahe_variants"
NVCC = "/usr/local/cuda/bin/nvcc"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry points before the redesign
PARENT_TYPES = {
    "mbfp_binarize_front": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "mbfp_clahe": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
}

F_VARIANTS = {
    "shipped": [],
    "1 output a thread": [("constexpr int kR = 8;", "constexpr int kR = 1;")],
    "4 outputs a thread": [("constexpr int kR = 8;", "constexpr int kR = 4;")],
    "16 outputs a thread": [("constexpr int kR = 8;", "constexpr int kR = 16;")],
    "region 32 wide": [("constexpr int kRegW = 64;", "constexpr int kRegW = 32;")],
    "region 128 wide": [("constexpr int kRegW = 64;",
                         "constexpr int kRegW = 128;"),
                        ],
    "region 128 wide, 4 outputs": [
        ("constexpr int kRegW = 64;", "constexpr int kRegW = 128;"),
        ("constexpr int kR = 8;", "constexpr int kR = 4;")],
    "3 blocks an SM": [("__launch_bounds__(kThreads, WIN ? 4 : 1)",
                        "__launch_bounds__(kThreads, WIN ? 3 : 1)")],
    "6 blocks an SM": [("__launch_bounds__(kThreads, WIN ? 4 : 1)",
                        "__launch_bounds__(kThreads, WIN ? 6 : 1)")],
    "diagnostic, stores of every block into one region": [
        ("    const size_t at = plane + (size_t)y * w + x;",
         "    const size_t at = plane + (size_t)(y & 31) * w + (x & 63);")],
    "diagnostic, vertical pass without its loads": [
        ("    const float a = src[y * w + col];",
         "    const float a = __int_as_float(y * w + col);")],
    "diagnostic, vertical pass without its adds": [
        ("    add_element(j, win, __fmul_rn(tap, a), __fmul_rn(tap, __fmul_rn(a, a)), m,\n"
         "                q);",
         "    m[j % kR] = __fmul_rn(tap, a); q[j % kR] = __fmul_rn(tap, __fmul_rn(a, a));")],
    "diagnostic, horizontal pass without its adds": [
        ("    for (int j = 0; j < kR + win - 1; ++j) add_element(j, win, p[j].x, p[j].y, m, q);",
         "    for (int j = 0; j < kR + win - 1; ++j) { m[j % kR] = p[j].x; q[j % kR] = p[j].y; }")],
    "window not known at compile time": [
        ("win == 25 ? launch_mean_std<25>", "win == 0 ? launch_mean_std<25>")],
    "a patch on 8 warps in launch 2": [("constexpr int kWarps2 = 4;",
                                        "constexpr int kWarps2 = 8;")],
    "a patch on 2 warps in launch 2": [("constexpr int kWarps2 = 4;",
                                        "constexpr int kWarps2 = 2;")],
}

# the four taps of a pixel from one word: the block packs, for each
# quadrant of its tile, the quadrant's four LUTs byte-interleaved
A_PACKED = [
    ("  __shared__ uint32_t staged[9][64];   // LUTs of the 3 x 3 tiles, as bytes\n",
     "  __shared__ uint32_t staged[9][64];   // LUTs of the 3 x 3 tiles, as bytes\n"
     "  __shared__ uint32_t packed[4][256];  // per quadrant: four LUTs a word\n"),
    ("  __syncthreads();\n"
     "  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&staged[0][0]);\n",
     "  __syncthreads();\n"
     "  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&staged[0][0]);\n"
     "  for (int i = tid; i < 1024; i += kThreads) {\n"
     "    // quadrant (qy, qx): slots qy, qy + 1 by qx, qx + 1 of the 3 x 3\n"
     "    const int v = i & 255, s = 3 * (i >> 9) + ((i >> 8) & 1);\n"
     "    packed[i >> 8][v] = (uint32_t)bytes[s * 256 + v] |\n"
     "                        (uint32_t)bytes[(s + 1) * 256 + v] << 8 |\n"
     "                        (uint32_t)bytes[(s + 3) * 256 + v] << 16 |\n"
     "                        (uint32_t)bytes[(s + 4) * 256 + v] << 24;\n"
     "  }\n"
     "  __syncthreads();\n"),
    ("        const uint8_t* lo = bytes + row.x * 256 + v;\n"
     "        const uint8_t* hi = bytes + row.y * 256 + v;\n"
     "        float acc = __fmul_rn((float)lo[s0 * 256], __fmul_rn(wy0, wx0));\n"
     "        acc = __fadd_rn(acc, __fmul_rn((float)lo[s1 * 256], __fmul_rn(wy0, wx1)));\n"
     "        acc = __fadd_rn(acc, __fmul_rn((float)hi[s0 * 256], __fmul_rn(wy1, wx0)));\n"
     "        acc = __fadd_rn(acc, __fmul_rn((float)hi[s1 * 256], __fmul_rn(wy1, wx1)));\n",
     "        const uint32_t t = packed[2 * (row.x / 3) + s0][v];\n"
     "        float acc = __fmul_rn((float)(t & 255u), __fmul_rn(wy0, wx0));\n"
     "        acc = __fadd_rn(acc, __fmul_rn((float)((t >> 8) & 255u), __fmul_rn(wy0, wx1)));\n"
     "        acc = __fadd_rn(acc, __fmul_rn((float)((t >> 16) & 255u), __fmul_rn(wy1, wx0)));\n"
     "        acc = __fadd_rn(acc, __fmul_rn((float)(t >> 24), __fmul_rn(wy1, wx1)));\n"),
]
A_VARIANTS = {
    "shipped": [],
    "LUT taps as one packed word a bin": A_PACKED,
    "1 histogram a block in pass 1": [("constexpr int kSubs = 2;",
                                       "constexpr int kSubs = 1;")],
    "4 histograms a block in pass 1": [("constexpr int kSubs = 2;",
                                        "constexpr int kSubs = 4;")],
    "8 histograms a block in pass 1": [("constexpr int kSubs = 2;",
                                        "constexpr int kSubs = 8;")],
    "1 row a batch in pass 2": [("constexpr int kBatch = 8;",
                                 "constexpr int kBatch = 1;")],
}


def nvcc_build(name: str, text: str, out: Path = OUT):
    """Compile ``text`` to a shared library in ``out``; (CDLL, ptxas
    lines)."""
    stem = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = out / f"{stem}.cu", out / f"lib{stem}.so"
    out.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    res = subprocess.run(
        [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
         "-o", str(so), str(cu)], capture_output=True, text=True, check=False)
    if res.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{res.stdout}\n{res.stderr}")
    lines = (res.stdout + res.stderr).splitlines()
    regs = []
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '\w*?\d+("
                          r"[a-z_]+_kernel(?:ILi\d+E)?)", line)
        if found:
            used = " ".join(lines[i + 1:i + 4])
            regs.append(found.group(1) + ": " + ", ".join(re.findall(
                r"\d+ registers|\d+ bytes smem|[1-9]\d* bytes spill \w+",
                used)))
    return ctypes.CDLL(str(so)), regs


def build_parent(entry: str):
    """One of the two parent kernels' libraries, its entry point typed."""
    source = ROOT / "tools" / ("binarize_parent.cu" if "binarize" in entry
                               else "clahe_parent.cu")
    lib, regs = nvcc_build("parent_" + entry, source.read_text())
    getattr(lib, entry).argtypes = PARENT_TYPES[entry]
    getattr(lib, entry).restype = _I
    return lib, regs


def build_variant(source: str, entry: str, name: str, subs):
    """The shipped source after ``subs``, typed like the port's library."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import (
        build as port_build)
    text = (CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: '{old}' not in {source}")
        text = text.replace(old, new)
    lib, regs = nvcc_build(f"{Path(source).stem}_{name}", text)
    getattr(lib, entry).argtypes = list(port_build._SIGNATURES[entry])
    getattr(lib, entry).restype = _I
    return lib, regs


def build_cluster():
    """``tools/binarize_cluster.cu``: the shipped source plus a one-launch
    form that keeps an image's mean and std in the shared memory of a
    thread-block cluster. ``run_f`` takes that form where the frame fits."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import (
        build as port_build)
    lib, regs = nvcc_build(
        "binarize_cluster", (ROOT / "tools" / "binarize_cluster.cu").read_text())
    lib.mbfp_binarize_front.argtypes = list(
        port_build._SIGNATURES["mbfp_binarize_front"])
    lib.mbfp_binarize_front_cluster.argtypes = PARENT_TYPES[
        "mbfp_binarize_front"]
    lib.mbfp_binarize_front_cluster.restype = _I
    lib.cluster_route = True
    return lib, [r for r in regs if "cluster" in r]


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def run_f(lib, parent: bool, img, win: int, otsu: bool, k: float = 0.25):
    """Kernel F's entry point of ``lib`` on (B, H, W) float32 -> bool."""
    import numpy as np
    import torch
    b, h, w = img.shape
    stdmax = torch.zeros((b,), dtype=torch.int32, device=img.device)
    out = torch.empty((b, h, w), dtype=torch.bool, device=img.device)
    tail = (b, h, w, win, float(np.float32(1.0 / win)), k, int(otsu), stream())
    if parent:
        rc = lib.mbfp_binarize_front(img.data_ptr(), stdmax.data_ptr(),
                                     out.data_ptr(), *tail)
    elif (getattr(lib, "cluster_route", False) and h % 32 == 0
          and w % 32 == 0 and h <= 512 and w <= 512):
        rc = lib.mbfp_binarize_front_cluster(
            img.data_ptr(), stdmax.data_ptr(), out.data_ptr(), *tail)
    else:
        scratch = torch.empty((2, b, h, w), dtype=torch.float32,
                              device=img.device)
        rc = lib.mbfp_binarize_front(
            img.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            stdmax.data_ptr(), out.data_ptr(), *tail)
    if rc:
        raise SystemExit(f"mbfp_binarize_front: CUDA error {rc}")
    return out


def run_a(lib, parent: bool, img, clip: float, grid: int = 8):
    """Kernel A's entry point of ``lib`` on (B, H, W) float32 ->
    (image, LUTs)."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_kernels import (
        _clip_limit)
    b, h, w = img.shape
    area = (h // grid) * (w // grid)
    lut = torch.empty((b, grid, grid, 256), device=img.device,
                      dtype=torch.float32 if parent else torch.uint8)
    out = torch.empty_like(img)
    rc = lib.mbfp_clahe(img.data_ptr(), lut.data_ptr(), out.data_ptr(), b, h,
                        w, grid, _clip_limit(clip, area), 255.0 / area,
                        stream())
    if rc:
        raise SystemExit(f"mbfp_clahe: CUDA error {rc}")
    return out, lut


def time_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ops(fn) -> str:
    """The device operations of one call of ``fn`` under ``torch.profiler``
    with their times, in launch order."""
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)    # a launch at the window's edge can go missing
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    ops = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return "; ".join(f"{e.name.replace('(anonymous namespace)::', '')[:28]} "
                     f"{e.time_range.elapsed_us() / 1e3:.4f} ms" for e in ops)


def differ(a, b) -> int:
    """Values that differ (a byte LUT against a float one by value)."""
    if isinstance(a, tuple):
        return sum(differ(x, y) for x, y in zip(a, b))
    return int((a.float() != b.float()).sum())


def report(title, cases, parent, libs, run, timed) -> bool:
    """Every library on every case against the parent and the shipped
    kernel, then ms per call on the ``timed`` cases in turns. ``cases``:
    name -> arguments of ``run`` after (lib, is_parent). True if any
    library differs anywhere."""
    import torch
    print(title)
    bad = False
    want = {name: (run(parent, True, *args), run(libs["shipped"][0], False,
                                                 *args))
            for name, args in cases.items()}
    torch.cuda.synchronize()
    print(f"  cases: {'; '.join(cases)}")
    for name, (lib, _) in libs.items():
        d_par = d_ship = n = 0
        for case, args in cases.items():
            got = run(lib, False, *args)
            torch.cuda.synchronize()
            one = (differ(got, want[case][0]), differ(got, want[case][1]))
            if any(one) and "diagnostic" not in name:
                print(f"  {name} | {case}: differs from the parent in "
                      f"{one[0]}, from the shipped kernel in {one[1]} values")
            d_par, d_ship = d_par + one[0], d_ship + one[1]
            n += sum(t.numel() for t in got) if isinstance(got, tuple) \
                else got.numel()
        print(f"  {name}: differs from the parent in {d_par}, from the "
              f"shipped kernel in {d_ship} of {n} values over "
              f"{len(cases)} cases")
        bad |= (d_par > 0 or d_ship > 0) and "diagnostic" not in name
    for case in timed:
        args = cases[case]
        print(f"  ms per call, {case}:")
        for name in ["parent", *libs, "shipped", "parent"]:
            if name == "parent":
                ms = time_ms(lambda: run(parent, True, *args))
            else:
                ms = time_ms(lambda lib=libs[name][0]: run(lib, False, *args))
            print(f"    {name}: {ms:.4f}")
        for name, lib, par in (("parent", parent, True),
                               ("shipped", libs["shipped"][0], False)):
            print(f"    device operations of one {name} call: "
                  + device_ops(lambda: run(lib, par, *args)))
    return bad


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("binarize_clahe_variants: needs a GPU")
    sys.path.insert(0, str(ROOT))
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.histogram import (
        clahe, percentile_stretch)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        preprocess_fingerprint)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.enhance import (
        _quantize_u8)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        make_batch)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")

    # every library at once: nvcc takes a few seconds a source
    cluster = "a cluster an image: one launch, no scratch (where it fits)"
    jobs = {("F", "parent"): lambda: build_parent("mbfp_binarize_front"),
            ("A", "parent"): lambda: build_parent("mbfp_clahe"),
            ("F", cluster): build_cluster}
    for name, subs in F_VARIANTS.items():
        jobs["F", name] = lambda name=name, subs=subs: build_variant(
            "binarize.cu", "mbfp_binarize_front", name, subs)
    for name, subs in A_VARIANTS.items():
        jobs["A", name] = lambda name=name, subs=subs: build_variant(
            "clahe.cu", "mbfp_clahe", name, subs)
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    for (kern, name), (_, regs) in built.items():
        print(f"{kern} {name}: ptxas: " + "; ".join(regs))
    f_parent, a_parent = built["F", "parent"][0], built["A", "parent"][0]
    f_libs = {name: lib for (kern, name), lib in built.items()
              if kern == "F" and name != "parent"}
    f_libs[cluster] = f_libs.pop(cluster)         # timed last
    a_libs = {name: lib for (kern, name), lib in built.items()
              if kern == "A" and name != "parent"}

    x = torch.from_numpy(make_batch(128)).cuda()
    res = preprocess_fingerprint(x)
    seg = _quantize_u8(res.segmented)
    img_eq = clahe(seg, clip_limit=2.5, grid=8)
    g = torch.Generator(device="cpu").manual_seed(11)
    rand = lambda *s: torch.rand(s, generator=g).cuda()
    u8 = lambda *s: (torch.randint(0, 256, s, generator=g).float() / 255.0).cuda()

    f_cases = {
        "main path (128, 320, 256), hybrid": (img_eq, 25, True),
        "main path (128, 320, 256), Sauvola alone": (img_eq, 25, False),
        "(4, 64, 96) random, hybrid": (rand(4, 64, 96), 25, True),
        "(4, 64, 96) u8 grid, hybrid, win 33": (u8(4, 64, 96), 33, True),
        "(1, 1024, 1024) random, hybrid": (rand(1, 1024, 1024), 25, True),
        "(3, 33, 70) ragged, Sauvola alone": (rand(3, 33, 70), 25, False),
        "(2, 7, 130) ragged, Sauvola alone, win 33": (rand(2, 7, 130), 33, False),
        "(2, 1, 1) Sauvola alone": (rand(2, 1, 1), 25, False),
        "(2, 320, 250) ragged, Sauvola alone, win 5": (rand(2, 320, 250), 5, False),
        "(1, 1000, 1021) ragged, Sauvola alone": (rand(1, 1000, 1021), 25, False),
    }
    bad = report("kernel F:", f_cases, f_parent, f_libs, run_f,
                 list(f_cases)[:2])
    a_cases = {
        "main path, normalize (clip 2.5)": (
            _quantize_u8(percentile_stretch(x, 0.5, 99.5)), 2.5),
        "main path, segment (clip 2.0)": (_quantize_u8(res.denoised), 2.0),
        "main path, binarize (clip 2.5)": (seg, 2.5),
        "(4, 64, 64) random": (rand(4, 64, 64), 2.0),
        "(4, 72, 40) u8 grid, tiles 9 x 5": (u8(4, 72, 40), 2.5),
        "(4, 40, 24) random, tiles 5 x 3": (rand(4, 40, 24), 2.0),
        "(2, 1024, 1024) u8 grid": (u8(2, 1024, 1024), 2.5),
        "(1, 2056, 2064) random, serial LUT order": (rand(1, 2056, 2064), 2.5),
        "(3, 8, 8) one pixel a tile": (rand(3, 8, 8), 2.5),
        "(2, 64, 96) u8 grid, grid 4": (u8(2, 64, 96), 2.5, 4),
        "(2, 64, 64) random, grid 16": (rand(2, 64, 64), 2.0, 16),
        "(2, 96, 32) random, grid 1": (rand(2, 96, 32), 3.0, 1),
    }
    bad |= report("kernel A (image and LUTs):", a_cases, a_parent, a_libs,
                  run_a, list(a_cases)[:1])
    print(f"card: {card}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
