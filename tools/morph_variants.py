#!/usr/bin/env python3
"""Holds kernel G (the binarize tail, a 3x3-cross opening) to the kernel it
replaced and times compile-time variants of it, on one GPU.

    python3 tools/morph_variants.py

Builds with nvcc into ``build/morph_variants/``, all at once: the parent
(``tools/morph_parent.cu``: a block an image, one byte a pixel in shared
memory, three stencils and the reconstruction's fixpoint loop, frames up to
232,448 pixels), the shipped ``csrc/morph.cu`` and the shipped source with
one substitution each (rows a band, threads a block, words a strip).

Inputs (``cases``): the mask kernel G takes on the main path
(``make_batch(128)`` through the binarize stage's front and filters), random
masks at five densities, the six adversarial masks, ragged frames from 1x1
to 131x195, a frame wider than a strip, and batches of 512x512 and
1024x1024 frames (the parent refuses those). For every library it prints
the pixels that differ from the plain twin on every case and from the
parent wherever the parent takes the frame (all must be 0), ms per call by
CUDA events around back-to-back calls and the device time of one launch
under ``torch.profiler``, at (128, 320, 256) and (4, 1024, 1024), taken in
turns (parent, shipped, variants, shipped, parent), and the card's name and
power limit.
Exits 1 on any difference. ``chip_smoke.py`` builds the parent and runs
``cases`` through this file.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "multimodal_biometric_fingerprints_palms_tpu_torch"
CSRC = ROOT / PKG / "csrc"
OUT = ROOT / "build" / "morph_variants"
PARENT = ROOT / "tools" / "morph_parent.cu"
PARENT_PIXELS = 232448        # the parent holds a frame a block, a byte a pixel

_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY = "mbfp_open_erode_reconstruct"

VARIANTS = {
    "shipped": [],
    "16 rows a band": [("constexpr int kRows = 32;", "constexpr int kRows = 16;")],
    "64 rows a band": [("constexpr int kRows = 32;", "constexpr int kRows = 64;")],
    "128 rows a band, 512 threads": [
        ("constexpr int kRows = 32;", "constexpr int kRows = 128;"),
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "128 threads": [("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;")],
    "32 words a strip": [("constexpr int kWords = 8;",
                          "constexpr int kWords = 32;")],
}


def _shared():
    """``tools/binarize_clahe_variants.py``, whose nvcc and timing helpers
    this tool shares."""
    spec = importlib.util.spec_from_file_location(
        "binarize_clahe_variants", ROOT / "tools" / "binarize_clahe_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nvcc_build(name: str, text: str):
    return _shared().nvcc_build(name, text, OUT)


def _typed(built):
    lib, regs = built
    getattr(lib, ENTRY).argtypes = [_P, _P, _I, _I, _I, _P]
    getattr(lib, ENTRY).restype = _I
    return lib, regs


def build_parent():
    """The parent kernel's library, its entry point typed; (CDLL, ptxas)."""
    return _typed(_nvcc_build("parent", PARENT.read_text()))


def build_variant(name: str, subs):
    """The shipped source after ``subs``, typed like the port's library."""
    text = (CSRC / "morph.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: '{old}' not in morph.cu")
        text = text.replace(old, new)
    return _typed(_nvcc_build(f"morph_{name}", text))


def run(lib, mask):
    """Kernel G's entry point of ``lib`` on a (B, H, W) bool mask."""
    import torch
    b, h, w = mask.shape
    src = mask.contiguous()
    out = torch.empty_like(src)
    rc = getattr(lib, ENTRY)(src.data_ptr(), out.data_ptr(), b, h, w,
                             torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"{ENTRY}: CUDA error {rc}")
    return out


def main_path_mask(x):
    """The (B, H, W) mask kernel G takes on the main path for images ``x``:
    the binarize stage's CLAHE, front (F), object filter and hole fill (B)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
        cuda_binarize, cuda_cc)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.histogram import (
        clahe)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        preprocess_fingerprint)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.enhance import (
        _quantize_u8)
    res = preprocess_fingerprint(x)
    img_eq = clahe(_quantize_u8(res.segmented), clip_limit=2.5, grid=8)
    fg = cuda_binarize.binarize_foreground_cuda(img_eq)
    kept = cuda_cc.cc_filter_cuda(fg, "remove_small", 1, min_size=80)
    return cuda_binarize.fill_holes_phase2(kept)


def cases(cleaned) -> dict:
    """Name -> (B, H, W) bool mask on ``cleaned``'s device: the main path's
    mask ``cleaned`` itself, and every other input the kernel is held on."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        adversarial_masks)
    dev = cleaned.device
    g = np.random.default_rng(8)
    rnd = lambda d, *s: torch.from_numpy(g.random(s) < d).to(dev)
    out = {f"main path {tuple(cleaned.shape)}": cleaned}
    for d in (0.3, 0.55, 0.8, 0.95, 1.0):
        out[f"random({d}) (8, 320, 256)"] = rnd(d, 8, 320, 256)
    out["adversarial (6, 320, 256): " + ", ".join(adversarial_masks(320, 256))] = \
        torch.from_numpy(np.stack(list(adversarial_masks(320, 256).values()))).to(dev)
    for h, w in ((1, 1), (5, 37), (7, 130), (33, 70), (131, 195), (40, 2100)):
        out[f"ragged random(0.55 / 0.8) (4, {h}, {w})"] = torch.cat(
            [rnd(0.55, 2, h, w), rnd(0.8, 2, h, w)])
    # stage masks side by side: ridges at frame sizes up to 1280x1024
    quilt = cleaned[:16].reshape(4, 4, *cleaned.shape[-2:]).permute(
        0, 2, 1, 3).reshape(4 * cleaned.shape[-2], 4 * cleaned.shape[-1])
    for nb, side in ((16, 512), (4, 1024)):
        ridges = [quilt.roll((37 * i, 53 * i), (0, 1))[:side, :side]
                  for i in range(nb - 1)]
        out[f"tiled stage masks + random(0.8) ({nb}, {side}, {side})"] = \
            torch.stack(ridges + [rnd(0.8, side, side)])
    return out


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of one launch of ``fn`` under ``torch.profiler``, over
    ``reps`` back-to-back calls: a call this short takes less time on the
    card than its wrapper takes on the host, so CUDA events around
    back-to-back calls time the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ops) / 1e3 / max(len(ops), 1)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("morph_variants: needs a GPU")
    sys.path.insert(0, str(ROOT))
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_morph import (
        open_erode_reconstruct_plain)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        make_batch)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    jobs = {"parent": build_parent}
    for name, subs in VARIANTS.items():
        jobs[name] = lambda name=name, subs=subs: build_variant(name, subs)
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = dict(zip(jobs, pool.map(lambda job: job(), jobs.values())))
    for name, (_, regs) in built.items():
        print(f"{name}: ptxas: " + "; ".join(regs))
    parent = built.pop("parent")[0]
    time_ms = _shared().time_ms

    cleaned = main_path_mask(torch.from_numpy(make_batch(128)).cuda())
    inputs = cases(cleaned)
    want = {k: open_erode_reconstruct_plain(m) for k, m in inputs.items()}
    bad = False
    for case, m in inputs.items():
        b, h, w = m.shape
        got = {name: run(lib, m) for name, (lib, _) in built.items()}
        if h * w <= PARENT_PIXELS:
            got["parent"] = run(parent, m)
        torch.cuda.synchronize()
        diff = {name: int((o != want[case]).sum()) for name, o in got.items()}
        bad |= any(diff.values())
        print(f"  {case}: pixels that differ from the twin: "
              + ", ".join(f"{k} {v}" for k, v in diff.items())
              + f" (of {m.numel()}; opening set {int(want[case].sum())})")
    big = next(m for k, m in inputs.items() if "1024" in k)
    for what, m in (("(128, 320, 256) main path", cleaned),
                    ("(4, 1024, 1024)", big)):
        print(f"  ms per call, {what}:")
        order = ["parent", *built, "shipped", "parent"]
        for name in order:
            if name == "parent":
                if m.shape[-2] * m.shape[-1] > PARENT_PIXELS:
                    continue
                fn = lambda: run(parent, m)
            else:
                fn = lambda lib=built[name][0]: run(lib, m)
            print(f"    {name}: {time_ms(fn):.4f} back to back, "
                  f"{device_ms(fn):.4f} device time of a launch")
    print(f"card: {card}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
