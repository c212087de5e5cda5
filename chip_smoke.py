#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_biometric_fingerprints_palms_tpu_torch/csrc``,
checks each kernel against its plain PyTorch twin on the card at the main
path's shapes (batch 128 of 320x256 images, on real stage inputs), then
drives the main path (``preprocess_fingerprint`` -> ``extract_minutiae`` ->
``postprocess_minutiae``) on ``bench.make_batch(128)``, asserts that it went
through every kernel, and checks its output. Imports nothing of JAX.

Prints the card's name and power limit, one JSON line with every kernel's
launches, error and times, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, when no
GPU is available, or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "multimodal_biometric_fingerprints_palms_tpu_torch"
BATCH = 128
# Skeleton agreement of the port on the card against the port on the CPU
# for the same images (same bound as tests/test_torch_enhance.py holds the
# port to against the JAX package): NLM's float sums and exp differ in the
# last bits between devices, which can move a ridge edge by one pixel.
MAX_SKEL_MISMATCH = 0.05      # of the CPU skeleton's pixels
MAX_COUNT_DIFF = 2            # valid minutiae per image
CLAHE_ATOL = 1.0 / 255.0 + 1e-6
CLAHE_MAX_OFF = 1e-3          # fraction of pixels allowed off by <= 1/255


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def blob_prints(n: int, h: int = 320, w: int = 256):
    """Synthetic prints with blob constellations that leave >= 8 minutiae
    after quality filtering (the generator of tests/test_end_to_end_eer.py;
    bench.make_batch's concentric prints keep only 2-7, in the JAX package
    and in the port alike)."""
    import numpy as np
    out = np.empty((n, h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.sqrt(((yy - h / 2) / 1.1) ** 2 + (xx - w / 2) ** 2)
    ang = np.arctan2(yy - h / 2, xx - w / 2)
    ridges = 0.5 + 0.5 * np.cos(r / 4.5 + 2.0 * np.sin(3 * ang))
    ell = (((yy - h / 2) / (0.42 * h)) ** 2
           + ((xx - w / 2) / (0.40 * w)) ** 2) < 1
    for i in range(n):
        g = np.random.default_rng(i)
        blobs = np.zeros((h, w), np.float32)
        for _ in range(110):
            by, bx = g.integers(40, h - 40), g.integers(40, w - 40)
            rr = g.integers(2, 6)
            blobs[by - rr:by + rr, bx - rr:bx + rr] = 1.0
        img = np.where(ell, 1.0 - 0.8 * ridges * (1 - 0.9 * blobs), 0.95)
        img = np.clip(img + g.normal(0, 0.02, (h, w)), 0, 1) * 255
        out[i] = img.astype(np.uint8).astype(np.float32) / 255.0
    return out


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_times(x) -> dict:
    """Wall time of each stage of the main path, synchronized around it."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        enhance as E)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.orientation import (
        compute_orientation_field)
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        extract_minutiae, postprocess_minutiae)
    out = {}

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*args)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return r

    n = timed("normalize", E.normalize_image, x)
    d = timed("denoise", E.denoise_image, n)
    s, m = timed("segment", E.segment_fingerprint, d)
    f = timed("orientation", lambda: compute_orientation_field(
        s, mask=m, block_size=16, smooth_sigma=3.0,
        smooth_orientation_sigma=3.0))
    b = timed("binarize", E.binarize, s)
    sm = timed("smooth", E.smooth_fingerprint_skeleton, b.float())
    sk = timed("thin", E.thinning_and_cleaning, sm, f.reliability)
    ms = timed("extract", extract_minutiae, sk)
    timed("postprocess", postprocess_minutiae, ms, sk)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a GPU")
    if not (ROOT / PKG).is_dir() or not (ROOT / "bench.py").is_file():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    from bench import make_batch
    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
        cuda_cc, cuda_kernels, cuda_thin)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.components import (
        clean_mask)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.filters import (
        gaussian_blur)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.histogram import (
        percentile_stretch)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.morphology import (
        binary_erode, binary_opening)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        preprocess_fingerprint, smooth_fingerprint_skeleton)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.enhance import (
        _quantize_u8)
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        extract_minutiae, postprocess_minutiae)

    # 1. device
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build+load: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds else 0:.2f} s)")
    log = build.BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    def run_path(x):
        res = preprocess_fingerprint(x)
        ms = extract_minutiae(res.skeleton)
        return res, postprocess_minutiae(ms, res.skeleton)

    x = torch.from_numpy(make_batch(BATCH)).to(dev)
    # warm-up run; its stage outputs are the kernels' real inputs below
    res, _ = run_path(x)
    torch.cuda.synchronize()

    # 3. kernels against their plain twins at the main path's shapes
    def compare_exact(name, kern, plain):
        a, b = kern(), plain()
        torch.cuda.synchronize()
        bad = int((a != b).sum())
        print(f"  {name}: mismatches {bad} / {a.numel()}")
        if bad:
            fail(f"{name}: kernel differs from its plain version")

    # the three CLAHE calls of the path: normalize, segment, binarize
    clahe_in = [(2.5, _quantize_u8(percentile_stretch(x, 0.5, 99.5))),
                (2.0, _quantize_u8(res.denoised)),
                (2.5, _quantize_u8(res.segmented))]
    clahe_err = 0.0
    print("kernel A (CLAHE):")
    for clip, inp in clahe_in:
        a = cuda_kernels.clahe_cuda(inp, clip, 8)
        b = cuda_kernels.clahe_plain(inp, clip, 8)
        torch.cuda.synchronize()
        d = (a - b).abs()
        err = float(d.max())
        off = float((d > 1e-6).float().mean())
        print(f"  clip {clip}: max|d| {err:.3g}, pixels off {off:.3g}")
        if not torch.isfinite(a).all() or err > CLAHE_ATOL or off > CLAHE_MAX_OFF:
            fail(f"CLAHE clip {clip} outside tolerance")
        clahe_err = max(clahe_err, err)
    inp = clahe_in[0][1]
    clahe_ms = time_ms(lambda: cuda_kernels.clahe_cuda(inp, 2.5, 8), 20)
    clahe_plain_ms = time_ms(lambda: cuda_kernels.clahe_plain(inp, 2.5, 8), 5)
    print(f"  time per call: kernel {clahe_ms:.4f} ms, plain {clahe_plain_ms:.4f} ms")

    print("kernel B (CC label + filter):")
    binary_smooth = smooth_fingerprint_skeleton(res.binary.float())
    opened = binary_opening(res.binary, 3, shape="ellipse")
    marker = binary_erode(opened, 3, shape="ellipse")
    masks = {"mask": res.mask, "binary": res.binary, "smooth": binary_smooth}
    for conn in (1, 2):
        for mname, m in masks.items():
            compare_exact(f"labels conn{conn} {mname}",
                          lambda: cuda_cc.cc_label_cuda(m, conn),
                          lambda: cuda_cc.cc_label_plain(m, conn))
        for mode, kw in (("remove_small", dict(min_size=80)),
                         ("fill_holes", dict(max_size=150)),
                         ("clean", dict(min_size=64, max_size=80)),
                         ("largest", {}),
                         ("reach", dict(marker=marker))):
            m = opened if mode == "reach" else binary_smooth
            compare_exact(f"{mode} conn{conn}",
                          lambda: cuda_cc.cc_filter_cuda(m, mode, conn, **kw),
                          lambda: cuda_cc.cc_filter_plain(m, mode, conn, **kw))
    cc_ms = time_ms(lambda: cuda_cc.cc_filter_cuda(
        binary_smooth, "clean", 1, min_size=64, max_size=80), 20)
    cc_plain_ms = time_ms(lambda: cuda_cc.cc_filter_plain(
        binary_smooth, "clean", 1, min_size=64, max_size=80), 3)
    print(f"  time per clean(64, 80) conn1 call: kernel {cc_ms:.4f} ms, "
          f"plain {cc_plain_ms:.4f} ms")

    print("kernel C (Zhang-Suen + prune):")
    gated = clean_mask(binary_smooth, 64, 80, connectivity=1) & (
        gaussian_blur(res.reliability, 2.0) > 0.1)
    for prune in (False, True):
        compare_exact(f"thin prune={prune}",
                      lambda: cuda_thin.zs_thin_cuda(gated, 128, prune),
                      lambda: cuda_thin.zs_thin_plain(gated, 128, prune))
    thin_ms = time_ms(lambda: cuda_thin.zs_thin_cuda(gated, 128, True), 20)
    thin_plain_ms = time_ms(lambda: cuda_thin.zs_thin_plain(gated, 128, True), 3)
    print(f"  time per call: kernel {thin_ms:.4f} ms, plain {thin_plain_ms:.4f} ms")

    print("small random shapes:")
    g = torch.Generator(device="cpu").manual_seed(0)
    for h, w in ((32, 32), (48, 64), (64, 64), (40, 24)):
        rnd = (torch.rand((8, h, w), generator=g) < 0.55).to(dev)
        mk = (torch.rand((8, h, w), generator=g) < 0.02).to(dev)
        for conn in (1, 2):
            compare_exact(f"labels {h}x{w} conn{conn}",
                          lambda: cuda_cc.cc_label_cuda(rnd, conn),
                          lambda: cuda_cc.cc_label_plain(rnd, conn))
            for mode, kw in (("clean", dict(min_size=6, max_size=9)),
                             ("largest", {}), ("reach", dict(marker=mk))):
                compare_exact(f"{mode} {h}x{w} conn{conn}",
                              lambda: cuda_cc.cc_filter_cuda(rnd, mode, conn, **kw),
                              lambda: cuda_cc.cc_filter_plain(rnd, mode, conn, **kw))
        compare_exact(f"thin {h}x{w}",
                      lambda: cuda_thin.zs_thin_cuda(rnd, 128, True),
                      lambda: cuda_thin.zs_thin_plain(rnd, 128, True))
        if h % 8 == 0 and w % 8 == 0:
            img = torch.rand((4, h, w), generator=g).to(dev)
            d = (cuda_kernels.clahe_cuda(img, 2.0, 8)
                 - cuda_kernels.clahe_plain(img, 2.0, 8)).abs()
            print(f"  clahe {h}x{w}: max|d| {float(d.max()):.3g}")
            if float(d.max()) > CLAHE_ATOL:
                fail("CLAHE outside tolerance at a small shape")

    # 4. main path, counted and timed
    print("main path:")
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, ms = run_path(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    print(f"  launches in one run: {launches}")
    expected = {"clahe": 3, "cc": 4, "thin": 1}
    if launches != expected:
        fail(f"launch counts {launches}, expected {expected}")
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        run_path(x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img_s = BATCH * iters / dt
    print(f"  {BATCH} images: counted run {first_s:.3f} s; {iters} more runs "
          f"{dt:.3f} s -> {img_s:.1f} img/s on {card}")

    # where the time goes: each stage alone, synchronized, host clock
    stage_ms = stage_times(x)
    print("  stage ms (one synchronized run): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stage_ms.items()))

    # output checks
    if res.skeleton.shape != x.shape or res.skeleton.dtype != torch.bool:
        fail("skeleton shape/dtype")
    for f in ("normalized", "denoised", "segmented", "orientation",
              "reliability"):
        if not torch.isfinite(getattr(res, f)).all():
            fail(f"non-finite {f}")
    if ms.xy.shape != (BATCH, 64, 2) or not torch.isfinite(ms.xy).all():
        fail("minutiae xy shape or values")
    counts = ms.count.cpu()
    print(f"  valid minutiae per image (make_batch): min {int(counts.min())}, "
          f"median {float(counts.float().median()):.0f}, max {int(counts.max())}")
    if int((counts > 0).sum()) < BATCH * 3 // 4:
        fail("most make_batch images yield no minutiae")

    n_cmp = 4
    res_c, ms_c = run_path(x[:n_cmp].cpu())
    sk_g = res.skeleton[:n_cmp].cpu()
    mism = int((sk_g != res_c.skeleton).sum())
    total = int(res_c.skeleton.sum())
    dcount = (ms.count[:n_cmp].cpu() - ms_c.count).abs()
    print(f"  card vs CPU port, {n_cmp} images: skeleton mismatches {mism} "
          f"of {total} skeleton px; valid-count diffs {dcount.tolist()}")
    if mism > MAX_SKEL_MISMATCH * total or int(dcount.max()) > MAX_COUNT_DIFF:
        fail("card and CPU port disagree beyond the stated bound")

    xb = torch.from_numpy(blob_prints(16)).to(dev)
    _, msb = run_path(xb)
    cb = msb.count.cpu()
    print(f"  valid minutiae per blob print: {cb.tolist()}")
    if int((cb >= 8).sum()) < 12:
        fail("fewer than 12 of 16 blob prints yield >= 8 minutiae")

    src = f"{PKG}/csrc"
    kernels = [
        {"name": "clahe", "route": "cuda", "source": f"{src}/clahe.cu",
         "replaces": "multimodal_biometric_fingerprints_palms_tpu/ops/"
                     "pallas_kernels.py:1460",
         "launches": launches["clahe"], "max_abs_err": clahe_err,
         "ms": clahe_ms, "plain_ms": clahe_plain_ms},
        {"name": "cc_label_filter", "route": "cuda", "source": f"{src}/cc.cu",
         "replaces": "multimodal_biometric_fingerprints_palms_tpu/ops/"
                     "pallas_cc.py:552",
         "launches": launches["cc"], "max_abs_err": 0.0,
         "ms": cc_ms, "plain_ms": cc_plain_ms},
        {"name": "zs_thin", "route": "cuda", "source": f"{src}/thin.cu",
         "replaces": "multimodal_biometric_fingerprints_palms_tpu/ops/"
                     "pallas_bitpack.py:382",
         "launches": launches["thin"], "max_abs_err": 0.0,
         "ms": thin_ms, "plain_ms": thin_plain_ms},
    ]
    for k in kernels:
        for key in ("ms", "plain_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                fail(f"{k['name']} {key} not finite")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
