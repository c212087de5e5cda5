#!/usr/bin/env python3
"""Holds kernel D (RANSAC hypothesis scoring) to the kernel it replaced, and
times compile-time variants of it, on one GPU.

    python3 tools/match_variants.py [--sass DIR]

Builds three kinds of library with nvcc into ``build/match_variants/``:
``tools/match_parent.cu`` (kernel D before its redesign: one warp per
hypothesis, ``rintf`` in the distance loop, feature planes staged by the
wrapper), the shipped ``csrc/match.cu``, and the shipped source with a few
text substitutions each (how the minimum is kept, the clamp-and-bias form
of the quantization, blocks per SM, the angle wrap, hypotheses per warp, B
minutiae per unrolled step, invalid B slots walked instead of skipped).

On the fixture templates (``tests/fixtures/parity_full``), K=64, for
(P, H) = (512, 300) under the FRR and the FAR gates, (4096, 300) and the
cascade screen's (512, 32), it prints for every library: count mismatches
against the parent kernel and against the plain twin (both must be 0),
max |d score| against each, and ms per call by CUDA events (beside it the
device time of one call under ``torch.profiler``: at H=32 a call is shorter
than the host takes to launch it), taken in turns
(parent, shipped, variants, shipped, parent); at 4096 pairs also the SM
clock and power draw while the shipped kernel runs. The parent's ms includes the
staging of its input planes, as its wrapper paid it on every call. Exits 1
if the shipped kernel's counts differ from the parent's or the twin's.
``--sass DIR`` also writes ``cuobjdump -sass`` of the parent and the shipped
kernel there and prints the instructions of each one's distance loop, per
distance and by opcode.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "multimodal_biometric_fingerprints_palms_tpu_torch"
SRC = ROOT / PKG / "csrc" / "match.cu"
PARENT = ROOT / "tools" / "match_parent.cu"
OUT = ROOT / "build" / "match_variants"
CUDA_BIN = Path("/usr/local/cuda/bin")
FIXTURES = ROOT / "tests" / "fixtures" / "parity_full"

KEEP_MIN = ("          m[r] = min(m[r], min(nn_key(px[r], py[r], b.x, b.y, jj),\n"
            "                               nn_key(px[r], py[r], b.z, b.w, jj + 1)));\n")
VARIANTS = {
    "shipped": [],
    "three-input minimum (__vimin3_u32)": [
        (KEEP_MIN,
         "          m[r] = __vimin3_u32(m[r], nn_key(px[r], py[r], b.x, b.y, jj),\n"
         "                              nn_key(px[r], py[r], b.z, b.w, jj + 1));\n")],
    # the quantization as scale 16, fminf at 2^18, bias 1.5 * 2^23
    "clamp instruction, bias 1.5 * 2^23": [
        ("constexpr float kScale = 0.03125f;", "constexpr float kScale = 16.0f;"),
        ("constexpr float kBias = 48.0f;", "constexpr float kBias = 12582912.0f;"),
        ("constexpr unsigned kKeyBase = 0x20000000u;",
         "constexpr unsigned kKeyBase = 0xA0000000u;"),
        ("  asm(\"fma.rn.sat.f32 %0, %1, %2, %3;\" : \"=f\"(d) : \"f\"(a), "
         "\"f\"(b), \"f\"(c));\n",
         "  d = fminf(__fmaf_rn(a, b, c), 262144.0f);\n"),
        ("      sbxy_f[2 * e] = -1.0e8f;\n      sbxy_f[2 * e + 1] = -1.0e8f;\n",
         "      sbxy_f[2 * e] = -1.0e10f;\n      sbxy_f[2 * e + 1] = -1.0e10f;\n")],
    "5 blocks an SM (launch bounds)": [
        ("__launch_bounds__(kWarps * 32)", "__launch_bounds__(kWarps * 32, 5)")],
    "6 blocks an SM (launch bounds)": [
        ("__launch_bounds__(kWarps * 32)", "__launch_bounds__(kWarps * 32, 6)")],
    "angle wrap through fmodf always": [
        ("  if (av < kTwoPi) r = v;\n", "  if (false) r = v;\n"),
        ("  else if (av < 2.0f * kTwoPi) r = copysignf(", "  else if (false) r = copysignf(")],
    # wrong on purpose: what the gates' angle wrap costs
    "diagnostic, no angle wrap (other results)": [
        ("      const float dang = wrap_abs(__fsub_rn(",
         "      const float dang = fabsf(__fsub_rn(")],
    "2 hypotheses a warp": [("constexpr int kHypWarp = 4;",
                             "constexpr int kHypWarp = 2;")],
    "8 hypotheses a warp": [("constexpr int kHypWarp = 4;",
                             "constexpr int kHypWarp = 8;")],
    "16 B minutiae a step": [("constexpr int kStep = 8;",
                              "constexpr int kStep = 16;")],
    # every slot walked, valid or not (the compaction stays)
    "diagnostic, invalid B slots not skipped": [
        ("      if (vb) {\n", "      {\n"),
        ("        sbxy_f[2 * before] = __fmul_rn(b_xy[2 * o], kScale);\n"
         "        sbxy_f[2 * before + 1] = __fmul_rn(b_xy[2 * o + 1], kScale);\n"
         "        sidx[before] = e;\n",
         "        sbxy_f[2 * e] = __fmul_rn(vb ? b_xy[2 * o] : -kFar, kScale);\n"
         "        sbxy_f[2 * e + 1] = __fmul_rn(vb ? b_xy[2 * o + 1] : -kFar, kScale);\n"
         "        sidx[e] = e;\n"),
        ("    if (e >= total && e < (total + kStep - 1) / kStep * kStep) {",
         "    if (e >= k && e < (k + kStep - 1) / kStep * kStep) {"),
        ("    if (e == 0) { snb[0] = total; snb[1] = first_invalid; }",
         "    if (e == 0) { snb[0] = k; snb[1] = k; }")],
}


def nvcc_build(name: str, text: str):
    """Compile ``text`` to a shared library; (CDLL, ptxas lines, .cu path)."""
    stem = "match_" + "".join(c if c.isalnum() else "_" for c in name)
    cu, so = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    OUT.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    res = subprocess.run(
        [str(CUDA_BIN / "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
         "-v", "-o", str(so), str(cu)],
        capture_output=True, text=True, check=False)
    if res.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{res.stdout}\n{res.stderr}")
    regs = [line.strip() for line in (res.stdout + res.stderr).splitlines()
            if "Used" in line or "spill" in line]
    return ctypes.CDLL(str(so)), "; ".join(regs), cu


def build_parent():
    """The parent kernel's library, with its entry point's types set."""
    lib, regs, cu = nvcc_build("parent", PARENT.read_text())
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mbfp_hypothesis_scores.argtypes = [P, P, P, P, P, P, I, I, I, F, F, F,
                                           F, I, I, P]
    lib.mbfp_hypothesis_scores.restype = I
    return lib, regs, cu


def build_variant(name: str, subs):
    """The shipped source after ``subs``, typed like the port's library."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import (
        build as port_build)
    text = SRC.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: '{old}' not in {SRC.name}")
        text = text.replace(old, new)
    lib, regs, cu = nvcc_build(name, text)
    lib.mbfp_hypothesis_scores.argtypes = list(
        port_build._SIGNATURES["mbfp_hypothesis_scores"])
    lib.mbfp_hypothesis_scores.restype = ctypes.c_int
    return lib, regs, cu


def parent_scores(lib, a, b, wa, wb, theta, t, has_cand, possible, p):
    """One call of the parent kernel as its wrapper made it: stage the
    feature planes and the hypothesis planes, then launch."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    pnum, k = a.valid.shape
    h = theta.shape[1]
    scores = torch.empty((pnum, h), dtype=torch.float32, device=theta.device)
    counts = torch.empty((pnum, h), dtype=torch.int32, device=theta.device)
    fa, fb = cm._features(a, b, wa, wb)
    hyp = torch.stack([theta, t[..., 0], t[..., 1], has_cand],
                      dim=1).to(torch.float32).contiguous()
    poss = possible.to(torch.float32).contiguous()
    dist2, sigma_d2, sigma_o2 = cm._gate_constants(p)
    rc = lib.mbfp_hypothesis_scores(
        fa.data_ptr(), fb.data_ptr(), hyp.data_ptr(), poss.data_ptr(),
        scores.data_ptr(), counts.data_ptr(), pnum, h, k, dist2,
        p.orient_thresh, sigma_d2, sigma_o2, int(bool(p.use_type)),
        int(p.min_inliers), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"parent mbfp_hypothesis_scores: CUDA error {rc}")
    return scores, counts


def variant_scores(lib, *args):
    """One call of the port's wrapper with ``lib`` in place of its library."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    real = cm._build.load_library
    cm._build.load_library = lambda: lib
    try:
        return cm.hypothesis_scores_cuda(*args)
    finally:
        cm._build.load_library = real


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


def device_ms(fn) -> float:
    """Device time of one call of ``fn`` under ``torch.profiler``: what a
    call costs the card where it is shorter than the host takes to launch."""
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
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def clock_under_load(fn, seconds: float = 0.4) -> str:
    """SM clock and power draw as ``nvidia-smi`` reads them while ``fn``
    keeps the card busy."""
    import time
    import torch
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def write_sass(cu: Path, out: Path, marker: str) -> str:
    """``cuobjdump -sass`` of ``cu`` into ``out``. Returns the length of the
    distance loop (the shortest loop that holds the opcode ``marker``, which
    occurs once per distance) with its instructions by opcode."""
    import re
    cubin = OUT / (cu.stem + ".cubin")
    subprocess.run(
        [str(CUDA_BIN / "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-cubin", "-o", str(cubin), str(cu)], check=True)
    text = subprocess.run([str(CUDA_BIN / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    code = []                                # (address, opcode, operands)
    for line in text.splitlines():
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?(\S+)(.*?);",
                     line)
        if m:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for addr, op, rest in code:
        target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) < addr:
            body = [o for a, o, _ in code if int(target.group(1), 16) <= a <= addr]
            if any(o.startswith(marker) for o in body):
                loops.append(body)
    if not loops:
        return f"no loop with {marker}"
    body = min(loops, key=len)
    dists = sum(o.startswith(marker) for o in body)
    ops = collections.Counter(o.split(".")[0] for o in body)
    return (f"{len(body)} instructions for {dists} distances = "
            f"{len(body) / dists:.2f} a distance ("
            + ", ".join(f"{o} {n}" for o, n in ops.most_common()) + ")")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", type=Path)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("match_variants: needs a GPU")
    sys.path.insert(0, str(ROOT))
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.dataset import (
        genuine_pairs, impostor_pairs, load_dataset)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams, _pair_stats, sample_hypotheses)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        _gather)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")

    parent, parent_regs, parent_cu = build_parent()
    libs = {name: build_variant(name, subs) for name, subs in VARIANTS.items()}
    print(f"parent: ptxas: {parent_regs}")
    for name, (_, regs, _) in libs.items():
        print(f"{name}: ptxas: {regs}")
    if args.sass:
        # one rounding conversion (FRND) a distance in the parent's loop,
        # one saturating fused multiply-add in the shipped kernel's
        for tag, cu, marker in (("parent", parent_cu, "FRND"),
                                ("shipped", libs["shipped"][2], "FFMA.SAT")):
            print(f"SASS {tag} ({args.sass / f'match_{tag}.sass'}), distance "
                  f"loop: " + write_sass(cu, args.sass / f"match_{tag}.sass",
                                         marker))

    ds = load_dataset(FIXTURES, max_per_user=4, device="cuda")
    pairs = np.concatenate([genuine_pairs(ds), impostor_pairs(ds)])
    frr = MatchParams(ransac_iter=300, dist_thresh=30.0,
                      orient_thresh=math.radians(30.0), min_inliers=6)
    far = frr._replace(dist_thresh=15.0, orient_thresh=math.radians(10.0),
                       min_inliers=12)
    screen = frr._replace(ransac_iter=32, full_iters=300, min_inliers=4)
    bad = False
    for label, pnum, p in (("FRR gates", 512, frr), ("FAR gates", 512, far),
                           ("FRR gates", 4096, frr), ("screen", 512, screen)):
        a, b = _gather(ds, pairs[:pnum, 0]), _gather(ds, pairs[:pnum, 1])
        wa, wb, _, _, possible, _ = _pair_stats(a, b)
        theta, t, cand = sample_hypotheses(a, b, wa, wb, p)
        call = (a, b, wa, wb, theta, t, cand, possible, p)
        print(f"{label}, P={len(pairs[:pnum])}, H={p.ransac_iter}, K=64:")
        s_par, c_par = parent_scores(parent, *call)
        # the twin's float64 temporaries are too large at 4096 pairs
        twin = cm.hypothesis_scores_plain(*call) if pnum <= 512 else None
        torch.cuda.synchronize()
        if pnum > 512:
            print("  SM clock, its maximum and power draw with the shipped "
                  "kernel running: " + clock_under_load(
                      lambda: variant_scores(libs["shipped"][0], *call)))
        order = ["parent", *libs, "shipped", "parent"]
        for name in order:
            if name == "parent":
                fn = lambda: parent_scores(parent, *call)
            else:
                fn = lambda lib=libs[name][0]: variant_scores(lib, *call)
            s, c = fn()
            ms = time_ms(fn)
            line = (f"  {name}: {ms:.4f} ms ({device_ms(fn):.4f} on the device "
                    f"alone); vs parent: count mismatches "
                    f"{int((c != c_par).sum())} / {c.numel()}, max|ds| "
                    f"{float((s - s_par).abs().max()):.3g}")
            wrong = int((c != c_par).sum())
            if twin is not None:
                wrong += int((c != twin[1]).sum())
                line += (f"; vs twin: count mismatches "
                         f"{int((c != twin[1]).sum())}, max|ds| "
                         f"{float((s - twin[0]).abs().max()):.3g}")
            print(line)
            bad |= name == "shipped" and wrong > 0
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
