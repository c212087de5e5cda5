#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_biometric_fingerprints_palms_tpu_torch/csrc``
and drives the port's paths on the card:

- enhance + extract: checks kernels A (CLAHE), B (connected components),
  C (thinning), E (non-local means), F (binarize front) and G
  (open/erode/reconstruct, a one-pass cross opening) against their plain
  PyTorch twins at the main path's shapes (batch 128 of 320x256 images, on
  real stage inputs), A, F and G also against the kernels they replaced
  (``tools/clahe_parent.cu``, ``tools/binarize_parent.cu``,
  ``tools/morph_parent.cu``, built here), A and F on odd tile sides and a
  1024x1024 frame, G on random, adversarial and ragged masks and on batches
  of 512x512 and 1024x1024 frames, then drives ``preprocess_fingerprint``
  -> ``extract_minutiae`` -> ``postprocess_minutiae`` on
  ``make_batch(128)`` (the port's copy of the
  JAX benchmark's input, ``utils/synthetic.py``), asserts that it
  went through every kernel, and checks its output;
- the 1:1 RANSAC matcher: checks kernel D (hypothesis scoring) against its
  plain twin and against the kernel it replaced (``tools/match_parent.cu``)
  at P=512 pairs, K=64, H=300 under the FRR, FAR and cascade
  screen parameters, times the full pass at chunks of 512 and 4096 pairs
  and breaks each chunk's host and device time down by step (the device
  time under ``torch.profiler``), runs the FRR/FAR/EER protocol of the reference golden
  (``tests/fixtures/parity_full_golden.json``) on the repository's 136
  templates with the cascade on and off and holds it to the golden's
  tolerances, and runs enhance -> match on 8 users x 2 sessions of
  synthetic prints under the production matching configuration;
- the file pipeline: ``pipeline.run_all(skip_ssl=True,
  demo_matching=False)`` from files on disk (``tools/polyu_set.py``: 160
  PolyU-shaped JPEGs of 320x240, a BMP, a colour PNG and a TIFF it must
  skip), counting each stage's kernel launches (A, B, C, E, F, G in
  preprocessing, D in matching), holding 4 images against the port on the
  CPU from the same files, checking every output file, the JSON schema,
  ``roc.png`` and the EER bounds, and printing each stage's seconds;
- the formats: every file of ``tests/fixtures/formats`` through the codec,
  grey and RGB, against OpenCV's digests in ``expected.json`` (ms a file
  by reader), then ``run_all`` over that 16-subject tree with 13 of its
  prints stored as progressive and colour JPEG, TIFF (none, Deflate,
  PackBits, LZW written by the port), 16-bit, palette and Adam7 PNG,
  32-bit and RLE8 BMP and orientation-tagged PNG and TIFF, against its
  twin tree: only the corrupt TIFF skipped, equal minutiae, masks and EER;
  one ``visualize_orientation`` timed;
- the gallery (``parallel/``): ``all_pairs_unique`` over 1,480 synthetic
  templates (``utils.synthetic.users_gallery``, 148 users x 10) at RANSAC
  300 with the cascade off, on, and on without its anchors (seconds,
  pairs/s, promoted share, kernel D's launches, peak device memory; cascade
  scores held to the full pass's, genuine above impostor), kernel D against
  its twin on a screen tile's shape, 64 templates on the card against the
  CPU, the screen's recall at ``min_inliers=6`` on 12-minutia templates,
  and ``identify`` / ``identify_batch`` (64 probes) against the gallery
  padded to 1,536 (ms/probe, top-1 user, each row equal to ``identify``);
- kernel C beyond one block's shared memory: its device-memory form
  against its twin at (2, 2048, 1024), (2, 1536, 1536), (1, 2048, 2048) and
  (1, 4096, 4096) on ridge quilts and adversarial masks, and a directory
  whose largest file is 2048x1024 through ``run_preprocessing``;
- the Gabor stage: ``preprocess_fingerprint(gabor=True)`` on
  ``make_batch(128)`` with the config's parameters (the cuDNN bank against
  the CPU port's tap-by-tap sums, the frequency map's blocks that differ,
  launches, img/s beside Gabor off, the stage's ms, 4 images against the
  CPU port) and the blob protocol with Gabor on;
- the ops off the enhance path (geometry, greyscale morphology, the
  bilateral filter, equalization, the spur trim), card against CPU port.
- training (no kernel: convolutions and products go to cuDNN and
  cuBLAS): the full-width SSL model through ``train_ssl`` on host views
  and the device-view step and ``train_ssl_device`` on 1,480 uint8 images
  of 320x240 (ms a step, views/s, host view ms, peak memory; step 0 moves
  no weight; two steps card against CPU port; the checkpoint read back),
  UNet++ through ``train_from_config`` on masks the preprocessing runner
  wrote, with a resume from ``last.msgpack``, and
  ``run_all(skip_ssl=False, train=True)`` from a raw tree to EER.

Imports nothing of JAX or of the JAX package (nor OpenCV, PIL, PyYAML,
pandas or matplotlib). Prints the card's name and
power limit, one JSON line with every kernel's launches, error, times and
bound (the least time the card could take: bytes over its memory rate or
operations over its float32 rate, whichever is larger), and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero on
any failure (a kernel timed under its bound is one: such a bound is none),
when no GPU is available, or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
# Kernel E visits the offsets in its twin's order with the twin's rounding
# points, so the aim is 0; the slack is for expf against torch.exp landing
# on the two sides of a bf16 rounding boundary.
NLM_ATOL = 1e-5
NLM_MAX_OFF = 1e-4            # fraction of pixels allowed off by > 1e-6
# Kernel F follows its twin operation by operation except for the order of
# the 1,024-term patch mean and variance sums, which can move the
# `p_std >= 3/255` gate of a patch that sits on it.
F_MAX_MISMATCH = 1e-3         # fraction of mask pixels
# Published peaks of one H100 SXM: device memory rate, and float32 rate
# outside the tensor cores (integer and logic operations are counted at the
# same rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# Matcher. Kernel D against its plain twin: counts exact; scores within
# 1e-6, because the warp's shuffle tree sums the K inlier scores in another
# order than the twin's sum. Against the kernel it replaced: counts exact.
D_ATOL = 1e-6
PARITY_FULL = ROOT / "tests" / "fixtures" / "parity_full"
GOLDEN = ROOT / "tests" / "fixtures" / "parity_full_golden.json"
CHUNK = 512                   # pairs per device chunk (the runner's default)
RATE_CHUNKS = (512, 4096)     # chunk sizes of the full-pass rate
H_FULL = 300                  # RANSAC hypotheses of the full pass
SCREEN_ITERS = 32             # configs/config_matching.yml matching.screen_iters
# configs/config_matching.yml's values, as constants: the script imports
# nothing of the checkout before main() has checked that it is one
PRODUCTION = dict(ransac_iter=300, stop_inlier_ratio=0.15, seed=42,
                  peers=100, num_points=50, max_per_user=2, cascade=True)
FRR_GATES = dict(dist_thresh=30.0, orient_thresh=math.radians(30.0),
                 min_inliers=6)
FAR_GATES = dict(dist_thresh=15.0, orient_thresh=math.radians(10.0),
                 min_inliers=12)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and to
    do ``ops`` operations, whichever is larger."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def thinning_work(mask) -> float:
    """Bitwise operations Zhang-Suen thinning needs on this batch, whatever
    implements it. Thinning is boolean algebra on the 3x3 neighbourhood, so
    the least work handles 32 pixels of a row as one word: per subpass and
    word that holds a set pixel about 100 two-input operations (18 for the
    six shifted neighbour planes with their carries, 30 for the adder tree
    and 2 <= B <= 6, 42 for the eight transitions and A == 1, 7 for the
    product and the removal: 97). Each image runs subpass pairs until one
    pair changes nothing, that pair included. (A count of 40 operations per
    set pixel, as for a pixel-per-thread kernel, is one a word-parallel
    kernel runs under, so it bounds nothing.)"""
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_thin import (
        _words_subpass, pack_words)
    words = pack_words(mask.reshape((-1,) + tuple(mask.shape[-2:])))
    live = words.new_ones(words.shape[0], dtype=bool)
    ops = 0.0
    while bool(live.any()):
        cur = words[live]
        mid = _words_subpass(cur, True)
        new = _words_subpass(mid, False)
        ops += 100.0 * float((cur != 0).sum() + (mid != 0).sum())
        words[live] = new
        live[live.clone()] = (new != cur).flatten(1).any(dim=1)
    return ops


def opening_work(mask) -> float:
    """Bitwise operations kernel G's function needs on this batch, whatever
    implements it. The reconstruction returns the opening whatever the mask
    (see ``csrc/morph.cu``), so the function is a cross erosion and a cross
    dilation; on 32 pixels of a row as one word each is two one-bit funnel
    shifts and four ANDs or ORs: 6 a word. The erosion is taken on the two
    rows beside each band of 32 rows too, as any banded form must."""
    nb, h, w = mask.reshape((-1,) + tuple(mask.shape[-2:])).shape
    words = nb * -(-w // 32)
    return 6.0 * words * (h + 2 * -(-h // 32)) + 6.0 * words * h


def reconstruct_sweeps(mask):
    """(sweeps per image, whether the fixpoint is the opening): the
    synchronous 8-connected dilations of the marker inside the opening that
    change anything, as the JAX kernel's fixpoint loop takes them. The
    argument in ``csrc/morph.cu`` says 1 for every image with an opening
    that the marker misses somewhere, else 0, and the fixpoint the
    opening."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.morphology import (
        binary_dilate, binary_erode, binary_opening)
    opened = binary_opening(mask, 3, shape="ellipse")
    reached = binary_erode(opened, 3, shape="ellipse")
    sweeps = torch.zeros(opened.shape[0], dtype=torch.int64,
                         device=opened.device)
    while True:
        new = binary_dilate(reached, 3, shape="rect") & opened
        changed = (new != reached).flatten(1).any(dim=1)
        if not bool(changed.any()):
            return sweeps, bool(torch.equal(reached, opened))
        sweeps += changed
        reached = new


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


def wall_s(fn):
    """(result, seconds) of ``fn`` on the host clock, synchronized."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_ops(fn) -> list:
    """The device operations (kernels, copies, fills) one call of ``fn``
    issues, as ``torch.profiler`` events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a short window has been seen to come back without the operation
        # at its edge (kernel D's one launch as none): keep the edges away
        # from ``fn`` by a pause and a sentinel kernel on either side, and
        # take the sentinels out by name
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and "spin_kernel" not in e.name]


def device_ms(ops) -> float:
    """Summed device time of ``profile_ops`` events, ms."""
    return sum(e.time_range.elapsed_us() for e in ops) / 1e3


def top_ops(ops, n: int = 5) -> str:
    """The ``n`` device operations with the most summed time, by name."""
    top = {}
    for e in ops:
        ms, cnt = top.get(e.name, (0.0, 0))
        top[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    ranked = sorted(top.items(), key=lambda kv: -kv[1][0])[:n]
    return "; ".join(f"{name[:70]} {ms:.3f} ms ({c})"
                     for name, (ms, c) in ranked)


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


def compare_exact(name: str, kern, plain) -> None:
    """Fail unless the kernel's output equals its plain version's."""
    import torch
    a, b = kern(), plain()
    torch.cuda.synchronize()
    bad = int((a != b).sum())
    print(f"  {name}: mismatches {bad} / {a.numel()}")
    if bad:
        fail(f"{name}: kernel differs from its plain version")


def kernel_b_adversarial(dev) -> None:
    """Kernel B against its twin where a tiled labelling is most likely to
    break: components that cross every tile seam many times (spiral,
    serpentine), the most runs a row holds (comb), the checkerboard (one
    component 8-connected, all singletons 4-connected), the trivial planes,
    frames that are no multiple of the tile, and frames far larger than a
    block's shared memory. Labels and all five modes, both connectivities;
    one line per input."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import cuda_cc
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        adversarial_masks)
    g = np.random.default_rng(5)
    inputs = {}
    for h, w in ((320, 256), (33, 70), (7, 130), (1, 1), (2, 2),
                 (1024, 1024)):
        for name, m in adversarial_masks(h, w).items():
            if h < 1024 or name in ("spiral", "serpentine", "checkerboard"):
                inputs[f"{h}x{w} {name}"] = m[None]
    inputs["1024x1024 random(0.55)"] = g.random((1, 1024, 1024)) < 0.55
    modes = (("remove_small", dict(min_size=40)),
             ("fill_holes", dict(max_size=40)),
             ("clean", dict(min_size=40, max_size=40)),
             ("largest", {}), ("reach", {}))
    for name, arr in inputs.items():
        m = torch.from_numpy(arr).to(dev)
        mk = torch.from_numpy(g.random(arr.shape) < 0.001).to(dev)
        bad, checks = 0, 0
        for conn in (1, 2):
            pairs = [(cuda_cc.cc_label_cuda(m, conn),
                      cuda_cc.cc_label_plain(m, conn))]
            for mode, kw in modes:
                if mode == "reach":
                    kw = dict(marker=mk)
                pairs.append((cuda_cc.cc_filter_cuda(m, mode, conn, **kw),
                              cuda_cc.cc_filter_plain(m, mode, conn, **kw)))
            torch.cuda.synchronize()
            bad += sum(int((a != b).sum()) for a, b in pairs)
            checks += len(pairs)
        print(f"  {name}: mismatches {bad} in {checks} comparisons "
              f"(labels + 5 modes, conn 1 and 2)")
        if bad:
            fail(f"kernel B differs from its plain version on {name}")


def kernel_c_frames(dev, gated) -> None:
    """Kernel C against its twin beyond the main path's shape: frames that
    are no multiple of a word (and one a single pixel), frames of 512x512
    and 1024x1024 (the second in device memory), each frame also in the
    device-memory form; on ridge masks
    cut or tiled from the stage mask ``gated``, thick and one-pixel spirals,
    one-pixel lines, the checkerboard and the trivial planes (a full frame
    thins for min(H, W) / 2 iterations); both ``prune`` values and
    ``max_iters`` of 1, 2 and 128; one line per frame."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import cuda_thin
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        adversarial_masks, spiral_mask)
    # 4 x 4 stage masks side by side: ridges at any frame size up to 1280x1024
    quilt = gated[:16].reshape(4, 4, *gated.shape[-2:]).permute(
        0, 2, 1, 3).reshape(4 * gated.shape[-2], 4 * gated.shape[-1])
    for h, w in ((320, 256), (33, 70), (7, 130), (1, 1), (320, 250),
                 (512, 512), (1024, 1024)):
        masks = {k: torch.from_numpy(v) for k, v in
                 adversarial_masks(h, w).items()}
        masks["thick spiral"] = torch.from_numpy(np.kron(
            spiral_mask(-(-h // 4), -(-w // 4)),
            np.ones((4, 4), bool))[:h, :w])
        batch = torch.stack([quilt[:h, :w], quilt[-h:, -w:]]
                            + [m.to(dev) for m in masks.values()])
        bad = checks = 0
        for iters in (1, 2, 128):
            for prune in (False, True):
                b = cuda_thin.zs_thin_plain(batch, iters, prune)
                for form in ("auto", "device"):
                    a = cuda_thin.zs_thin_cuda(batch, iters, prune, form)
                    torch.cuda.synchronize()
                    bad += int((a != b).sum())
                    checks += 1
        print(f"  {h}x{w}: mismatches {bad} in {checks} comparisons of "
              f"{batch.shape[0]} masks (ridges x2, {', '.join(masks)}; "
              f"max_iters 1, 2, 128; prune off and on; the size's form and "
              f"the device-memory form)")
        if bad:
            fail(f"kernel C differs from its plain version at {h}x{w}")
    full = torch.ones((2, 320, 256), dtype=torch.bool, device=dev)
    compare_exact("thin full 320x256 to its fixpoint (max_iters 1024)",
                  lambda: cuda_thin.zs_thin_cuda(full, 1024, True),
                  lambda: cuda_thin.zs_thin_plain(full, 1024, True))
    for nb, h, w in ((32, 512, 512), (8, 1024, 1024)):
        big = torch.stack([quilt.roll((37 * i, 53 * i), (0, 1))[:h, :w]
                           for i in range(nb)])
        ms = time_ms(lambda: cuda_thin.zs_thin_cuda(big, 128, True), 10)
        other = ""
        if h * -(-w // 32) * 8 <= 232448:       # one block takes the frame
            other = " (device-memory form {:.4f} ms)".format(time_ms(
                lambda: cuda_thin.zs_thin_cuda(big, 128, True, "device"), 10))
        b_ms, b_by = bound(2.0 * big.numel(), thinning_work(big))
        print(f"  {nb} frames of {h}x{w} (tiled stage masks): kernel {ms:.4f} "
              f"ms{other}, bound {b_ms:.4f} ms ({b_by})")


# (batch, H, W) of kernel C's frames beyond one block's shared memory
C_LARGE = ((2, 2048, 1024), (2, 1536, 1536), (1, 2048, 2048), (1, 4096, 4096))


def kernel_c_large_frames(dev, gated) -> list:
    """Kernel C's device-memory form against its twin on frames whose packed
    image exceeds one block's shared memory: the batch of ridge quilts
    (stage masks tiled, each image shifted), and the adversarial masks with
    a thick spiral (the one-pixel spiral's Python walk is too slow at these
    sizes) as a second batch; ``max_iters`` 1, 2 and 128, prune off and on.
    Returns one dict a frame with the ridge batch's time and bound."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import cuda_thin
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        spiral_mask)
    hs, ws = gated.shape[-2:]
    n = min(16, gated.shape[0])
    quilt = gated[:n].reshape(-1, 4, hs, ws).permute(0, 2, 1, 3).reshape(
        -1, 4 * ws)                                   # (n / 4 * hs, 4 * ws)
    out = []
    for nb, h, w in C_LARGE:
        reps = (-(-h // quilt.shape[0]), -(-w // quilt.shape[1]))
        tiled = quilt.repeat(*reps)
        ridges = torch.stack([tiled.roll((97 * i, 61 * i), (0, 1))[:h, :w]
                              for i in range(nb)])
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        masks = {
            "thick spiral": torch.from_numpy(np.kron(
                spiral_mask(-(-h // 8), -(-w // 8)),
                np.ones((8, 8), bool))[:h, :w]).to(dev),
            "serpentine": ((yy % 2 == 0) | ((yy % 4 == 1) & (xx == w - 1))
                           | ((yy % 4 == 3) & (xx == 0))),
            "checkerboard": (yy + xx) % 2 == 0,
            "comb": (xx % 2 == 0) | (yy == 0),
            "full": torch.ones((h, w), dtype=torch.bool, device=dev),
            "empty": torch.zeros((h, w), dtype=torch.bool, device=dev),
        }
        adv = torch.stack(list(masks.values()))
        bad = checks = 0
        for batch in (ridges, adv):
            for iters in (1, 2, 128):
                for prune in (False, True):
                    a = cuda_thin.zs_thin_cuda(batch, iters, prune)
                    b = cuda_thin.zs_thin_plain(batch, iters, prune)
                    torch.cuda.synchronize()
                    bad += int((a != b).sum())
                    checks += 1
                    del a, b
        ms = time_ms(lambda: cuda_thin.zs_thin_cuda(ridges, 128, True), 5)
        b_ms, b_by = bound(2.0 * ridges.numel(), thinning_work(ridges))
        print(f"  ({nb}, {h}, {w}): mismatches {bad} in {checks} comparisons "
              f"(ridge quilts x{nb}; {', '.join(masks)}; max_iters 1, 2, 128; "
              f"prune off and on); ridges: kernel {ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
        if bad:
            fail(f"kernel C differs from its plain version at ({nb}, {h}, {w})")
        out.append({"shape": [nb, h, w], "ms": ms, "bound_ms": b_ms,
                    "bound_by": b_by})
    return out


def kernel_e_small_frames(dev) -> None:
    """Kernel E against its twin on frames smaller than its halo and no
    multiple of its tiles or strips, and on frames where the two bodies of
    the kernel meet, in both precisions; one line per frame."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
        cuda_nlm, denoise)
    g = torch.Generator(device="cpu").manual_seed(3)
    for h, w in ((2, 2), (5, 37), (33, 70), (64, 64), (70, 67), (131, 195)):
        img = torch.rand((3, h, w), generator=g).to(dev)
        out = []
        for prec in ("bf16", "f32"):
            a = cuda_nlm.nlm_denoise_cuda(img, precision=prec)
            d = (a - denoise.nlm_denoise_plain(img, precision=prec)).abs()
            torch.cuda.synchronize()
            out.append(f"{prec} max|d| {float(d.max()):.3g}, pixels that "
                       f"differ {int((d > 0).sum())} / {d.numel()}")
            if not torch.isfinite(a).all() or not float(d.max()) <= NLM_ATOL:
                fail(f"NLM {prec} outside tolerance at {h}x{w}")
        print(f"  nlm {h}x{w}: " + "; ".join(out))


def kernel_g_phase(dev, cleaned, binary, tool, parent) -> dict:
    """Kernel G against its plain twin, against ``open_cross_words_plain``
    and against the kernel it replaced (``tools/morph_parent.cu``, wherever
    that one takes the frame) on the main path's mask ``cleaned`` and on
    ``tools/morph_variants.cases``; the reconstruction's changing sweeps on
    ``cleaned`` (the identity, seen on the card); its time beside the
    twin's, the parent's and the bound; the device operations of one call;
    and its time on 512x512 and 1024x1024 batches."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import cuda_morph
    compare_exact("binarize tail on the cleaned mask",
                  lambda: cuda_morph.open_erode_reconstruct_cuda(cleaned),
                  lambda: cuda_morph.open_erode_reconstruct_plain(cleaned))
    if not bool((cuda_morph.open_erode_reconstruct_cuda(cleaned) == binary).all()):
        fail("F -> B -> G composed by hand differs from the path's binary mask")
    sweeps, fixpoint_is_opening = reconstruct_sweeps(cleaned)
    print(f"  the twin's reconstruction on the cleaned mask: changing sweeps "
          f"per image {sorted(set(sweeps.tolist()))} (images with 1: "
          f"{int((sweeps == 1).sum())} of {sweeps.numel()}); fixpoint equal "
          f"to the opening: {fixpoint_is_opening}")
    if int(sweeps.max()) > 1 or not fixpoint_is_opening:
        fail("the reconstruction is not the identity on the cleaned mask")
    # against the twin everywhere, the word algebra's twin on the card, and
    # the parent kernel wherever it takes the frame
    for case, m in tool.cases(cleaned).items():
        got = cuda_morph.open_erode_reconstruct_cuda(m)
        want = cuda_morph.open_erode_reconstruct_plain(m)
        words = cuda_morph.open_cross_words_plain(m)
        fits = m.shape[-2] * m.shape[-1] <= tool.PARENT_PIXELS
        old = tool.run(parent, m) if fits else None
        torch.cuda.synchronize()
        bad = (int((got != want).sum()), int((got != words).sum()),
               int((got != old).sum()) if fits else None)
        print(f"  {case}: mismatches {bad[0]} against the twin, {bad[1]} "
              f"against open_cross_words_plain, "
              + (f"{bad[2]} against the parent kernel" if fits
                 else "the parent refuses the frame")
              + f" (of {m.numel()}; opening set {int(want.sum())})")
        if any(bad[:2]) or bad[2]:
            fail(f"kernel G differs on {case}")
    kern = lambda: cuda_morph.open_erode_reconstruct_cuda(cleaned)
    old = lambda: tool.run(parent, cleaned)
    # in turns: parent, kernel, kernel, parent
    turns = [time_ms(fn, 20) for fn in (old, kern, kern, old)]
    g_ms, g_parent_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    g_plain_ms = time_ms(
        lambda: cuda_morph.open_erode_reconstruct_plain(cleaned), 3)
    g_bound = bound(2.0 * cleaned.numel(), opening_work(cleaned))
    print(f"  time per call, back to back: kernel {g_ms:.4f} ms, plain "
          f"{g_plain_ms:.4f} ms, parent kernel {g_parent_ms:.4f} ms (in turns: "
          + ", ".join(f"{t:.4f}" for t in turns)
          + f"), bound {g_bound[0]:.4f} ms ({g_bound[1]})")
    # ten calls a window: a window has been seen to come back one device
    # op short, which rounds away over ten
    calls = 10
    g_ops = profile_ops(lambda: [kern() for _ in range(calls)])
    parent_ops = profile_ops(lambda: [old() for _ in range(calls)])
    g_per_call = round(len(g_ops) / calls)
    g_dev = device_ms(g_ops) / max(len(g_ops), 1)
    print(f"  device ops of {calls} wrapper calls: {len(g_ops)} "
          f"({top_ops(g_ops, 2)}), {g_dev:.4f} ms each; the parent's: "
          f"{len(parent_ops)}, "
          f"{device_ms(parent_ops) / max(len(parent_ops), 1):.4f} ms each")
    if g_per_call != 1:
        fail(f"kernel G's wrapper launched {g_per_call} device ops a call, not 1")
    for nb, side in ((16, 512), (4, 1024)):
        big = torch.rand((nb, side, side), generator=torch.Generator(
            device="cpu").manual_seed(side)).to(dev) < 0.8
        b_ms, b_by = bound(2.0 * big.numel(), opening_work(big))
        fn = lambda: cuda_morph.open_erode_reconstruct_cuda(big)
        ops = profile_ops(lambda: [fn() for _ in range(calls)])
        print(f"  ({nb}, {side}, {side}) random(0.8): kernel {time_ms(fn, 20):.4f}"
              f" ms back to back, {device_ms(ops) / max(len(ops), 1):.4f} ms "
              f"device time a call, bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=g_ms, plain_ms=g_plain_ms, parent_ms=g_parent_ms,
                bound=g_bound, device_ops_per_call=g_per_call, device_ms=g_dev)


# --- the matcher ------------------------------------------------------------

def gather_pairs(ds, pairs):
    """The (P, K) A and B MinutiaeSets of (P, 2) sample-index pairs."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        _gather)
    return _gather(ds, pairs[:, 0]), _gather(ds, pairs[:, 1])


def load_tool(name: str):
    """A script under ``tools/`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_d_phase(ds, pairs, many) -> dict:
    """Kernel D against its plain twin and against the kernel it replaced
    (``tools/match_parent.cu``, built here) on the pairs' (P, K) templates,
    under the FRR gates, the FAR gates and the cascade screen's parameters,
    and once more with validity scattered over the slots, some pairs without
    a valid B slot and two hypotheses per pair that put an A minutia onto
    the point the invalid B slots are displaced to (the kernel skips
    invalid B slots, and there one of them is the nearest neighbour):
    counts equal to both, scores within ``D_ATOL`` of the twin. Then its
    time at the FRR gates beside the twin's, the parent's and the bound, at
    the screen's H, and on the ``many`` pairs of a 4096 chunk; and the
    device operations one wrapper call launches, before and after."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams, _apply_rigid, _pair_stats, sample_hypotheses)
    tool = load_tool("match_variants")
    parent, parent_regs, _ = tool.build_parent()
    print(f"  parent kernel built: ptxas: {parent_regs}")
    frr = MatchParams(ransac_iter=H_FULL, **FRR_GATES)
    cases = {
        f"FRR gates, H={H_FULL}": frr,
        f"FAR gates, H={H_FULL}": MatchParams(ransac_iter=H_FULL, **FAR_GATES),
        f"screen, H={SCREEN_ITERS} of {H_FULL}": frr._replace(
            ransac_iter=SCREEN_ITERS, full_iters=H_FULL,
            min_inliers=frr.min_inliers - 2),
    }

    def call_args(prs, p, scattered=False):
        a, b = gather_pairs(ds, prs)
        if scattered:
            g = torch.Generator(device="cpu").manual_seed(7)
            keep = lambda v: v & (torch.rand(v.shape, generator=g)
                                  < 0.7).to(v.device)
            a, b = a._replace(valid=keep(a.valid)), b._replace(valid=keep(b.valid))
            b.valid[::16] = False
        wa, wb, _, _, possible, _ = _pair_stats(a, b)
        theta, t, cand = sample_hypotheses(a, b, wa, wb, p)
        if scattered:
            spot = torch.tensor([-1e6 + 3.0, -1e6 - 2.0], device=t.device)
            for h, i in ((-1, 0), (-2, 1)):
                t[:, h] = spot - _apply_rigid(a.xy[:, i], theta[:, h], 0.0)
        return (a, b, wa, wb, theta, t, cand, possible, p)

    err, err_parent, timed = 0.0, 0.0, {}
    for name, p in (*cases.items(), ("scattered validity, FRR gates", frr)):
        args = call_args(pairs, p, scattered=name.startswith("scattered"))
        sk, ck = cm.hypothesis_scores_cuda(*args)
        sp, cp = cm.hypothesis_scores_plain(*args)
        so, co = tool.parent_scores(parent, *args)
        torch.cuda.synchronize()
        bad, bad_parent = int((ck != cp).sum()), int((ck != co).sum())
        e, e_parent = float((sk - sp).abs().max()), float((sk - so).abs().max())
        print(f"  {name}: P={sk.shape[0]} H={sk.shape[1]}: count mismatches "
              f"{bad} / {ck.numel()} against the twin, {bad_parent} against "
              f"the parent kernel; max|ds| {e:.3g} against the twin, "
              f"{e_parent:.3g} against the parent; scores > 0 "
              f"{int((sk > 0).sum())}")
        if bad or e > D_ATOL or not torch.isfinite(sk).all():
            fail(f"kernel D differs from its plain twin ({name})")
        if bad_parent:
            fail(f"kernel D's counts differ from the parent kernel's ({name})")
        if int((sk > 0).sum()) == 0:
            fail(f"kernel D comparison is trivial ({name}): no score > 0")
        err, err_parent = max(err, e), max(err_parent, e_parent)
        timed[name] = args
    frr_args, _, screen_args, _ = timed.values()
    ms = time_ms(lambda: cm.hypothesis_scores_cuda(*frr_args), 20)
    plain_ms = time_ms(lambda: cm.hypothesis_scores_plain(*frr_args), 3)
    parent_ms = time_ms(lambda: tool.parent_scores(parent, *frr_args), 20)
    # the matcher's tensors (x, y, orientation, type, weight, valid per
    # minutia of A and B; theta, tx, ty, has_cand per hypothesis;
    # `possible`) and both outputs; about 10 float operations per distance
    # from a transformed valid A minutia to a valid B minutia (the invalid
    # slots of a template share one point, so they need one distance, not
    # one each: the count is what these templates need, not K * K)
    def d_bound(args):
        a, b, theta = args[0], args[1], args[4]
        (pn, kk), h = a.valid.shape, theta.shape[1]
        dists = float((a.valid.sum(dim=1) * b.valid.sum(dim=1)).sum()) * h
        return bound(pn * (2 * kk * 21 + 4 * (4 * h + 1 + 2 * h)),
                     10.0 * dists)

    pn = frr_args[0].valid.shape[0]
    b_ms, b_by = d_bound(frr_args)
    valid = torch.cat([frr_args[0].valid, frr_args[1].valid]).sum(dim=1)
    print(f"  valid minutiae per template of these pairs: min "
          f"{int(valid.min())}, mean {float(valid.float().mean()):.1f}, max "
          f"{int(valid.max())} of {frr_args[0].valid.shape[1]} slots")
    print(f"  time per call (P={pn}, H={H_FULL}, K=64): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, parent kernel with its staging "
          f"{parent_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    ops_new = profile_ops(lambda: cm.hypothesis_scores_cuda(*frr_args))
    ops_old = profile_ops(lambda: tool.parent_scores(parent, *frr_args))
    print(f"  device ops of one wrapper call: {len(ops_new)} "
          f"({top_ops(ops_new, 3)}); the parent's wrapper: {len(ops_old)}")
    # at the screen's H a call is shorter than the host takes to launch it,
    # so back-to-back calls time the host; the device time is the profiler's
    s_ms = device_ms(profile_ops(
        lambda: cm.hypothesis_scores_cuda(*screen_args)))
    s_parent = device_ms(profile_ops(
        lambda: tool.parent_scores(parent, *screen_args)))
    s_host = time_ms(lambda: cm.hypothesis_scores_cuda(*screen_args), 20)
    if s_ms == 0.0:
        print("  torch.profiler shows no device operation for the screen's "
              "call: its back-to-back time stands in")
        s_ms = s_host
    s_bound = d_bound(screen_args)
    print(f"  device time of one call (P={pn}, H={SCREEN_ITERS}): kernel "
          f"{s_ms:.4f} ms, parent with its staging {s_parent:.4f} ms, bound "
          f"{s_bound[0]:.4f} ms ({s_bound[1]}); back-to-back calls "
          f"{s_host:.4f} ms each")
    big = call_args(many, frr)
    big_ms = time_ms(lambda: cm.hypothesis_scores_cuda(*big), 10)
    big_parent = time_ms(lambda: tool.parent_scores(parent, *big), 10)
    big_bound = d_bound(big)
    same = int((cm.hypothesis_scores_cuda(*big)[1]
                != tool.parent_scores(parent, *big)[1]).sum())
    print(f"  time per call (P={len(many)}, H={H_FULL}): kernel {big_ms:.4f} "
          f"ms, parent {big_parent:.4f} ms, bound {big_bound[0]:.4f} ms "
          f"({big_bound[1]}); count mismatches against the parent {same}")
    if same:
        fail("kernel D's counts differ from the parent kernel's at 4096 pairs")
    for what, t_ms, t_bound in (("H=300", ms, b_ms), ("H=32", s_ms, s_bound[0]),
                                ("P=4096", big_ms, big_bound[0])):
        if t_ms < t_bound:
            fail(f"kernel D ({what}) timed under its bound")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, device_ops_per_call=len(ops_new),
                parent_ms=parent_ms, max_abs_diff_parent=err_parent)


def chunk_profile(ds, pairs, reps: int = 5) -> None:
    """Where one chunk's time goes. For the full pass's steps (sampling with
    the per-pair stats, kernel D's wrapper call, the finish), the
    whole pass and the cascade screen, on the same (P, K) templates:

    - host ms: the host clock around one call, synchronized before and
      after it, mean of ``reps`` calls after a warm-up. The steps are each
      synchronized, so their sum exceeds the whole pass by the overlap of
      one step's device work with the next step's launches;
    - device ms: under ``torch.profiler``, the summed durations of the
      device operations (kernels, copies, fills) one call issues, and
      their count;
    - device busy share: the whole pass's device ms over its host ms."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams, _finish_match, _pair_stats, sample_hypotheses)
    a, b = gather_pairs(ds, pairs)
    p = MatchParams(ransac_iter=H_FULL, **FRR_GATES)
    screen_p = p._replace(ransac_iter=SCREEN_ITERS, full_iters=H_FULL,
                          min_inliers=max(3, p.min_inliers - 2))
    st = {}

    def sample():
        st["stats"] = _pair_stats(a, b)
        wa, wb = st["stats"][:2]
        st["hyp"] = sample_hypotheses(a, b, wa, wb, p)

    def score():
        wa, wb, _, _, possible, _ = st["stats"]
        st["scores"] = cm.hypothesis_scores_cuda(a, b, wa, wb, *st["hyp"],
                                                 possible, p)

    def finish():
        wa, wb, na, nb, possible, reject = st["stats"]
        theta, t, _ = st["hyp"]
        _finish_match(a, b, wa, wb, possible, na, nb, reject, *st["scores"],
                      theta, t, p)

    steps = {"sample": sample, "kernel D": score, "finish": finish,
             "whole pass": lambda: cm.match_pairs_batch(a, b, p),
             "screen": lambda: cm.screen_promote_batch(a, b, screen_p)}
    host, device, whole = {}, {}, []
    for name, fn in steps.items():
        fn()
        host[name] = sum(wall_s(fn)[1] for _ in range(reps)) / reps * 1e3
        ops = profile_ops(fn)
        device[name] = (device_ms(ops), len(ops))
        if name == "whole pass":
            whole = ops
    n = len(pairs)
    part = ("sample", "kernel D", "finish")
    print(f"  chunk {n}, host ms per call, synchronized: " + ", ".join(
        f"{k} {host[k]:.3f}" for k in steps)
        + f"; sum of the three steps {sum(host[k] for k in part):.3f}")
    print(f"  chunk {n}, device ms (device ops) under torch.profiler: "
          + ", ".join(f"{k} {device[k][0]:.3f} ({device[k][1]})"
                      for k in steps)
          + f"; whole pass busy {device['whole pass'][0] / host['whole pass']:.1%}"
          f" of its host ms")
    print(f"  chunk {n}, whole pass, top device ops: " + top_ops(whole))


def protocol(ds, frr_p, far_p, cascade: bool, peers: int, seed: int,
             num_points: int) -> dict:
    """The FRR/FAR/EER protocol of the JAX package's ``runner.main``: every
    genuine pair under the FRR gates, the sampled impostor pairs under the
    FAR gates, 50-point threshold sweeps, interpolated EER."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.evaluation import (
        compute_eer, evaluate_far_across_thresholds,
        evaluate_frr_across_thresholds)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.dataset import (
        genuine_pairs, impostor_pairs)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        match_pair_indices)
    g_pairs = genuine_pairs(ds)
    i_pairs = impostor_pairs(ds, peers_per_user=peers, seed=seed)
    g, t_g = wall_s(lambda: match_pair_indices(
        ds, g_pairs, frr_p, CHUNK, cascade, SCREEN_ITERS)["final_score"])
    i, t_i = wall_s(lambda: match_pair_indices(
        ds, i_pairs, far_p, CHUNK, cascade, SCREEN_ITERS)["final_score"])
    thr, frr = evaluate_frr_across_thresholds(g, num_points)
    _, far = evaluate_far_across_thresholds(i, num_points)
    eer, _ = compute_eer(thr, frr, far)
    n = len(g_pairs) + len(i_pairs)
    print(f"  cascade={cascade}: {len(g_pairs)} genuine + {len(i_pairs)} "
          f"impostor pairs in {t_g + t_i:.3f} s ({t_g:.3f} + {t_i:.3f}) -> "
          f"{n / (t_g + t_i):.1f} pairs/s; genuine mean {g.mean():.4f}, "
          f"impostor mean {i.mean():.4f}, EER {eer:.4f}")
    return dict(g_pairs=g_pairs, i_pairs=i_pairs, genuine=g, impostor=i,
                frr=frr, far=far, eer=eer)


def check_golden(run: dict, golden: dict, name: str) -> None:
    """The tolerances of tests/test_full_protocol_parity.py."""
    import numpy as np
    ref = np.asarray(golden["frr"])
    our = np.asarray(run["frr"])
    tol = 2.5 / 192.0      # FRR: one threshold bin of slack +- 2.5 pairs
    lo = np.minimum(np.minimum(ref, np.roll(ref, 1)), np.roll(ref, -1))
    hi = np.maximum(np.maximum(ref, np.roll(ref, 1)), np.roll(ref, -1))
    lo[0], hi[0], lo[-1], hi[-1] = ref[0], ref[0], ref[-1], ref[-1]
    frr_viol = float(np.max(np.maximum(our - (hi + tol), (lo - tol) - our)))
    far_d = float(np.max(np.abs(np.asarray(run["far"])
                                - np.asarray(golden["far"]))))
    eer_d = abs(run["eer"] - golden["eer"])
    g_d = abs(run["genuine"].mean() - np.mean(golden["genuine_scores"]))
    i_d = abs(run["impostor"].mean() - np.mean(golden["impostor_scores"]))
    print(f"  {name} vs golden: FRR band excess {frr_viol:.4f} (<= 0), "
          f"max|dFAR| {far_d:.4f} (<= 0.03), |dEER| {eer_d:.4f} (<= 0.015), "
          f"|d genuine mean| {g_d:.4f} (<= 0.04), |d impostor mean| "
          f"{i_d:.4f} (<= 0.01)")
    if frr_viol > 0 or far_d > 0.03 or eer_d > 0.015 or g_d > 0.04 \
            or i_d > 0.01:
        fail(f"{name}: outside the golden's tolerances")


def expected_chunks(ds, pairs, params, cascade: bool) -> int:
    """Kernel-D launches ``match_pair_indices`` makes for ``pairs``: one per
    screen chunk and one per full-pass chunk of the promoted pairs."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        screen_pair_indices)
    chunks = lambda n: -(-n // CHUNK)
    if not cascade or params.ransac_iter <= SCREEN_ITERS:
        return chunks(len(pairs))
    promoted = screen_pair_indices(ds, pairs, params, CHUNK, SCREEN_ITERS)
    print(f"    screen promoted {int(promoted.sum())} of {len(pairs)} pairs")
    return chunks(len(pairs)) + chunks(int(promoted.sum()))


def golden_phase(dev, build) -> int:
    """The reference golden's protocol on the 136 fixture templates, cascade
    off and on. Returns kernel D's launches in the cascade run (the
    production route)."""
    import numpy as np
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.dataset import (
        load_dataset)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    golden = json.loads(GOLDEN.read_text())
    pr = golden["protocol"]
    ds = load_dataset(PARITY_FULL, max_per_user=pr["max_per_user"], k=64,
                      device=dev)
    print(f"  {len(ds.users)} users, {len(ds.matrices)} templates on {dev}")

    def params(gates):
        return MatchParams(dist_thresh=float(gates["dist"]),
                           orient_thresh=math.radians(gates["orient_deg"]),
                           min_inliers=int(gates["min_inliers"]),
                           ransac_iter=int(pr["ransac_iter"]),
                           stop_inlier_ratio=float(pr["stop_inlier_ratio"]),
                           seed=42)

    frr_p, far_p = params(pr["frr"]), params(pr["far"])
    runs, launches = {}, {}
    for cascade in (False, True):
        for k in build.LAUNCHES:
            build.LAUNCHES[k] = 0
        run = protocol(ds, frr_p, far_p, cascade, peers=100, seed=42,
                       num_points=pr["num_points"])
        launches[cascade] = dict(build.LAUNCHES)
        want = (expected_chunks(ds, run["g_pairs"], frr_p, cascade)
                + expected_chunks(ds, run["i_pairs"], far_p, cascade))
        print(f"    launches {launches[cascade]}; kernel-D chunks expected "
              f"{want}")
        if launches[cascade] != {**dict.fromkeys(build.LAUNCHES, 0),
                                 "match": want}:
            fail(f"cascade={cascade}: launch counts {launches[cascade]}, "
                 f"expected {want} kernel-D chunks and nothing else")
        check_golden(run, golden, f"cascade={cascade}")
        runs[cascade] = run

    same = all(np.array_equal(runs[True][k], runs[False][k])
               for k in ("frr", "far")) and runs[True]["eer"] == runs[False]["eer"]
    if same:
        print("  the cascade leaves the FRR and FAR curves and the EER unchanged")
    else:
        for kind, pk in (("genuine", "g_pairs"), ("impostor", "i_pairs")):
            d = np.nonzero(runs[True][kind] != runs[False][kind])[0]
            for j in d:
                print(f"  CASCADE CHANGED {kind} pair {runs[True][pk][j].tolist()}: "
                      f"{runs[False][kind][j]:.6f} -> {runs[True][kind][j]:.6f}")
        print("  the cascade changed the curves; its run is held to the "
              "golden's tolerances above")
    return launches[True]["match"]


def blob_protocol_phase(dev, run_path, build) -> None:
    """Enhance -> extract -> JSON -> dataset -> match on 8 users x 2 sessions
    of blob prints (tests/test_end_to_end_eer.py's set, without its JPEG
    round trip), under the production matching configuration."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.dataset import (
        load_dataset)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.io import (
        minutiae_to_json, save_minutiae_json)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        blob_prints)
    names = [(u, s) for u in range(1, 9) for s in (1, 2)]
    x = torch.from_numpy(blob_prints([10 + u for u, _ in names],
                                     [0.06 * (s - 1) for _, s in names])).to(dev)
    _, ms = run_path(x)
    fields = [f.cpu().numpy() for f in ms]
    pr = PRODUCTION
    with tempfile.TemporaryDirectory() as tmp:
        for i, (u, s) in enumerate(names):
            save_minutiae_json(Path(tmp) / f"{u}_1_{s}_minutiae.json",
                               minutiae_to_json(*(f[i] for f in fields)))
        ds = load_dataset(tmp, max_per_user=pr["max_per_user"], device=dev)
    counts = [len(m) for m in ds.matrices]
    print(f"  {len(ds.users)} users, valid minutiae per template {counts}")
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    mk = lambda gates: MatchParams(ransac_iter=pr["ransac_iter"],
                                   stop_inlier_ratio=pr["stop_inlier_ratio"],
                                   seed=pr["seed"], **gates)
    run = protocol(ds, mk(FRR_GATES), mk(FAR_GATES), pr["cascade"],
                   pr["peers"], pr["seed"], pr["num_points"])
    print(f"    launches {dict(build.LAUNCHES)}")
    gap = float(run["genuine"].mean() - run["impostor"].mean())
    print(f"    EER {run['eer']:.4f}, genuine - impostor mean {gap:.4f}")
    if len(ds.users) != 8 or len(run["g_pairs"]) != 8:
        fail("blob protocol: expected 8 users with 2 templates each")
    if build.LAUNCHES["match"] == 0:
        fail("blob protocol did not launch kernel D")
    if not (np.isfinite(run["genuine"]).all()
            and np.isfinite(run["impostor"]).all()):
        fail("blob protocol: non-finite scores")
    if gap < 0.3 or run["eer"] > 0.13:
        fail(f"blob protocol: genuine - impostor mean {gap:.4f} (>= 0.3), "
             f"EER {run['eer']:.4f} (<= 0.13)")


def matcher_phases(dev, build, card, blob_templates, run_path) -> dict:
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.dataset import (
        MinutiaeDataset, genuine_pairs, impostor_pairs, load_dataset)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        match_pair_indices)

    # 1. kernel D at production width, on the 136 fixture templates and the
    # enhance path's 16 blob-print templates in one gallery
    print("kernel D (RANSAC hypothesis scoring):")
    fix = load_dataset(PARITY_FULL, max_per_user=4, device=dev)
    nfix = len(fix.matrices)
    gds = MinutiaeDataset([], np.zeros(0), np.zeros(0), [], MinutiaeSet(
        *(torch.cat([f, bt]) for f, bt in zip(fix.stacked, blob_templates))))
    nblob = blob_templates.valid.shape[0]
    fix_pairs = np.concatenate([genuine_pairs(fix), impostor_pairs(fix)])
    blob_pairs = np.asarray([(nfix + i, nfix + j) for i in range(nblob)
                             for j in range(i + 1, nblob)], np.int32)
    d_pairs = np.concatenate([blob_pairs, fix_pairs])[:CHUNK]
    many = fix_pairs[:max(RATE_CHUNKS)]
    d = kernel_d_phase(gds, d_pairs, many)

    # full-pass rate at chunk 512 and 4096 (one chunk each, synchronized),
    # and where each chunk's time goes
    p = MatchParams(ransac_iter=H_FULL, **FRR_GATES)
    reps = 3
    for chunk in RATE_CHUNKS:
        match_pair_indices(gds, many[:chunk], p, chunk=chunk)
        _, secs = wall_s(lambda: [match_pair_indices(gds, many[:chunk], p,
                                                     chunk=chunk)
                                  for _ in range(reps)])
        print(f"  full pass, H={H_FULL}, chunk {chunk}: {secs / reps * 1e3:.2f} ms "
              f"per chunk -> {chunk * reps / secs:.1f} pairs/s on {card}")
    for chunk in RATE_CHUNKS:
        chunk_profile(gds, many[:chunk])

    # 2. the golden protocol
    print("golden protocol (tests/fixtures/parity_full, RANSAC 300):")
    d["launches"] = golden_phase(dev, build)

    # 3. enhance -> match
    print("enhance -> match (8 users x 2 sessions of blob prints, "
          "production configuration):")
    blob_protocol_phase(dev, run_path, build)
    return d


# --- the Gabor stage, a large frame from a file, the ops off the path ----------

# configs/config_fingerprint.yml's preprocessing.gabor, without ``enabled``
# (constants: the script imports nothing of the checkout before main())
GABOR = dict(n_orientations=12, n_frequencies=4, block_size=32, kernel_size=11)
# The card computes the Gabor bank as one cuDNN convolution in full float32
# (enhance.exact_float32), the CPU as the tap-by-tap sums of conv2d_same in
# the JAX package's order: the same products summed in another order, on
# responses up to about 12.
GABOR_BANK_ATOL = 1e-5
# the frequency map: a block's value may differ only where the two FFTs
# break a tie between bins, or by the fallback mean's float sums
FREQ_ATOL = 1e-6


def gabor_phase(dev, build, card, x, run_path, off_run_path) -> dict:
    """The ``gabor=True`` path on the card: the bank and the selection
    against the CPU port on the path's own stage inputs, the frequency map's
    blocks that differ from the CPU port's, the path's launches (counts set
    to 0 just before it and read just after) and img/s beside Gabor off (in
    turns: off, on, on, off), the stage's ms alone, 4 images against the
    CPU port (the enhance bounds), and the blob protocol with Gabor on."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import gabor as G
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        enhance as E)
    res, _ = run_path(x)
    torch.cuda.synchronize()
    seg, mask, ori = res.segmented, res.mask, res.orientation

    fm = G.estimate_ridge_frequency_blockwise(seg, mask=mask,
                                              block_size=GABOR["block_size"])
    fm_cpu = G.estimate_ridge_frequency_blockwise(
        seg.cpu(), mask=mask.cpu(), block_size=GABOR["block_size"])
    d = (fm.cpu() - fm_cpu).abs()
    flipped = int((d > FREQ_ATOL).sum())
    images = int((d > FREQ_ATOL).flatten(1).any(dim=1).sum())
    # what the bank sees: each block's nearest of the n_frequencies bins
    fbins = torch.logspace(math.log10(1 / 16), math.log10(1 / 4),
                           GABOR["n_frequencies"], dtype=torch.float64)
    nearest = lambda f: (f.double()[..., None] - fbins).abs().argmin(-1)
    bins = int((nearest(fm.cpu()) != nearest(fm_cpu)).sum())
    print(f"  frequency map, card vs CPU port: {flipped} of {d.numel()} "
          f"blocks differ by > {FREQ_ATOL:g}, in {images} of {d.shape[0]} "
          f"images (max |d| {float(d.max()):.3g}); blocks whose Gabor "
          f"frequency bin differs: {bins}")
    kw = dict(n_orientations=GABOR["n_orientations"],
              n_frequencies=GABOR["n_frequencies"], size=GABOR["kernel_size"])
    n = 16
    resp = G.gabor_enhance_blockfreq(seg[:n], ori[:n], fm[:n], mask=mask[:n],
                                     **kw)
    resp_cpu = G.gabor_enhance_blockfreq(seg[:n].cpu(), ori[:n].cpu(),
                                         fm[:n].cpu(), mask=mask[:n].cpu(),
                                         **kw)
    bank_err = float((resp.cpu() - resp_cpu).abs().max())
    print(f"  bank (cuDNN, float32) and gather against the tap-by-tap sums "
          f"and where loop of the CPU port, {n} images: max |d| "
          f"{bank_err:.3g} (responses up to {float(resp_cpu.abs().max()):.3g})")
    if not bank_err <= GABOR_BANK_ATOL:
        fail(f"Gabor bank on the card off the CPU port by {bank_err:.3g}")

    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    res, ms = run_path(x)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"  launches in one run with Gabor on: {launches}")
    expected = {"clahe": 3, "cc": 4, "thin": 1, "match": 0, "nlm": 1,
                "binarize": 1, "morph": 1}
    if launches != expected:
        fail(f"Gabor path launch counts {launches}, expected {expected}")
    iters = 3
    rates = {}
    for name, fn in (("off", off_run_path), ("on", run_path),
                     ("on", run_path), ("off", off_run_path)):
        _, secs = wall_s(lambda: [fn(x) for _ in range(iters)])
        rates.setdefault(name, []).append(x.shape[0] * iters / secs)
    stage_ms = time_ms(lambda: E.gabor_stage(seg, mask, ori, dict(GABOR)), 5)
    print(f"  {x.shape[0]} images, img/s in turns off, on, on, off: "
          f"off {rates['off'][0]:.1f} / {rates['off'][1]:.1f}, on "
          f"{rates['on'][0]:.1f} / {rates['on'][1]:.1f}; the Gabor stage "
          f"alone {stage_ms:.2f} ms a batch; on {card}")
    if not torch.isfinite(ms.xy).all() or res.skeleton.shape != x.shape:
        fail("Gabor path: skeleton shape or minutiae values")

    n_cmp = 4
    res_c, ms_c = run_path(x[:n_cmp].cpu())
    mism = int((res.skeleton[:n_cmp].cpu() != res_c.skeleton).sum())
    total = int(res_c.skeleton.sum())
    dcount = (ms.count[:n_cmp].cpu() - ms_c.count).abs()
    print(f"  card vs CPU port with Gabor on, {n_cmp} images: skeleton "
          f"mismatches {mism} of {total} skeleton px; valid-count diffs "
          f"{dcount.tolist()}")
    if mism > MAX_SKEL_MISMATCH * total or int(dcount.max()) > MAX_COUNT_DIFF:
        fail("Gabor on: card and CPU port disagree beyond the stated bound")

    print("  enhance -> match with Gabor on (8 users x 2 sessions of blob "
          "prints, production configuration):")
    blob_protocol_phase(dev, run_path, build)
    return {"launches": launches, "img_s_on": rates["on"],
            "img_s_off": rates["off"], "stage_ms": stage_ms,
            "flipped_blocks": flipped, "flipped_bins": bins,
            "bank_err": bank_err}


def large_frame_file_phase(dev, build) -> None:
    """A directory of 4 files, three 320x240 protocol prints and one of
    2048x1024 (a frame the JAX package's native reader refuses and kernel
    C's one-block form could not take), through ``run_preprocessing`` on
    the card: the run pads to 2048x1024, and must complete with every
    kernel of the path launched and a skeleton in every output."""
    import os
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        runner as prun)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        encode_jpeg)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.io import (
        read_image_grayscale)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        protocol_print)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cluster = root / "sorted" / "cluster_0"
        cluster.mkdir(parents=True)
        for u in (1, 2, 3):
            (cluster / f"{u}_1_1.jpg").write_bytes(
                encode_jpeg(protocol_print(10 + u, 0.0, 320, 240)))
        (cluster / "4_1_1.jpg").write_bytes(
            encode_jpeg(protocol_print(14, 0.0, 2048, 1024)))
        try:
            os.chdir(root)
            for k in build.LAUNCHES:
                build.LAUNCHES[k] = 0
            stats, secs = wall_s(lambda: prun.run_preprocessing(
                root / "sorted", root / "processed", batch_size=4,
                debug=False))
            launches = dict(build.LAUNCHES)
        finally:
            os.chdir(cwd)
        skel = [int((read_image_grayscale(
            root / "processed" / "enhanced" / "cluster_0"
            / f"{u}_1_1_skeleton.jpg") > 127).sum()) for u in (1, 2, 3, 4)]
    print(f"  4 files (one 2048x1024): {stats['num_images']} images at "
          f"{tuple(stats['canonical_shape'])} in {secs:.2f} s (reader "
          f"{stats['reader']}); launches {launches}; skeleton px per image "
          f"{skel}")
    expected = {"clahe": 3, "cc": 4, "thin": 1, "match": 0, "nlm": 1,
                "binarize": 1, "morph": 1}
    if stats["num_images"] != 4 or tuple(stats["canonical_shape"]) != (
            2048, 1024):
        fail("large-frame run: images or canonical shape")
    if launches != expected:
        fail(f"large-frame run: launches {launches}, expected {expected}")
    if min(skel) < 500:
        fail("large-frame run: an image came out without a skeleton")


# float tolerances of the ops off the path, card against the CPU port (the
# CPU tests hold the CPU port to the JAX package at the same ones)
OPS_ATOL = {"rotate_points": 1e-4, "angle_diff": 1e-6,
            "orientation_diff": 1e-6, "resize_bilinear up": 1e-6,
            "resize_bilinear down": 1e-6, "affine_warp": 1e-4,
            "bilateral_filter": 1e-6}


def ops_phase(dev) -> None:
    """The ops the port carries beside the enhance path, each on the card
    against the port on the CPU on the same inputs: exact where the CPU
    tests hold them exact, else within OPS_ATOL; the float native loader
    raises as the JAX one does where its library does not build, and the
    config dump prints the tree."""
    import contextlib
    import io
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.config import loader
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
        denoise, geometry, histogram, morphology, skeleton)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
        native_loader)
    g = np.random.default_rng(12)
    img = torch.from_numpy(g.random((4, 320, 256), dtype=np.float32))
    ang = torch.from_numpy(g.uniform(-10, 10, (2, 4096)).astype(np.float32))
    pts = torch.from_numpy(g.uniform(-150, 150, (64, 64, 2)).astype(np.float32))
    theta = torch.from_numpy(g.uniform(-3.14, 3.14, (64,)).astype(np.float32))
    sk = torch.from_numpy(g.random((4, 320, 256)) < 0.2)
    mat = np.array([[0.978, 0.2079, -20.0], [-0.2079, 0.978, 35.0]])
    calls = {
        "rotate_points": lambda t: geometry.rotate_points(t["pts"], t["theta"]),
        "angle_diff": lambda t: geometry.angle_diff(t["ang"][0], t["ang"][1]),
        "orientation_diff": lambda t: geometry.orientation_diff(
            t["ang"][0], t["ang"][1]),
        "resize_bilinear up": lambda t: geometry.resize_bilinear(
            t["img"], (400, 333)),
        "resize_bilinear down": lambda t: geometry.resize_bilinear(
            t["img"], (160, 97)),
        "affine_warp": lambda t: geometry.affine_warp(t["img"][0], mat, 0.95),
        "prune_endpoints": lambda t: skeleton.prune_endpoints(t["sk"], 3),
        "equalize_hist": lambda t: histogram.equalize_hist(t["img"]),
        "bilateral_filter": lambda t: denoise.bilateral_filter(t["img"]),
        "reconstruction_by_dilation": lambda t: (
            morphology.reconstruction_by_dilation(
                morphology.erode(t["img"], 9), t["img"])),
    }
    for op in ("dilate", "erode", "opening", "closing"):
        for size, shape in ((3, "rect"), (15, "ellipse")):
            calls[f"{op} {size} {shape}"] = (
                lambda t, op=op, size=size, shape=shape: getattr(
                    morphology, op)(t["img"][:, :317, :250], size, shape))
    cpu = dict(img=img, ang=ang, pts=pts, theta=theta, sk=sk)
    card = {k: v.to(dev) for k, v in cpu.items()}
    for name, fn in calls.items():
        a, b = fn(card), fn(cpu)
        torch.cuda.synchronize()
        if a.dtype == torch.bool:
            err = float((a.cpu() != b).sum())
        else:
            err = float((a.cpu().double() - b.double()).abs().max())
        tol = OPS_ATOL.get(name, 0.0)
        print(f"  {name}: card vs CPU port max |d| {err:.3g} (bound {tol:g})")
        if not err <= tol:
            fail(f"{name}: card and CPU port differ by {err:.3g}")
    try:
        native_loader.batch_load(["missing.jpg"], 8, 8)
        print("  batch_load: the native library loaded here")
    except RuntimeError as e:
        print(f"  batch_load: RuntimeError ({e}), as the JAX binding raises "
              "without the library")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loader.print_config_summary(loader.load_fingerprint_config(),
                                    "fingerprint")
    lines = out.getvalue().splitlines()
    print(f"  print_config_summary: {len(lines)} lines, first {lines[0]!r}")
    if len(lines) < 10:
        fail("print_config_summary printed too little")


# --- the file pipeline --------------------------------------------------------

# subjects of the PolyU-shaped set (tools/polyu_set.py): x 10 impressions
FILE_SUBJECTS = 16
FILE_CMP = 4                  # images run on the card and on the CPU
REFERENCE_KEYS = {"x", "y", "type", "orientation", "quality", "coherence",
                  "angular_stability"}


def file_pipeline_phase(dev, build, card) -> dict:
    """``pipeline.run_all(skip_ssl=True, demo_matching=False)`` of the port
    on the card over ``tools/polyu_set.py``'s files at 16 subjects: 160
    JPEGs of 320x240, a BMP, a colour PNG and a TIFF (the production matching
    configuration: cascade on, RANSAC 300), in a temporary working
    directory. Checks every output file, the catalog's rows, the kernels'
    launches per stage (each stage's counts set to 0 just before it and read
    just after), 4 images on the card against the port on the CPU from the
    same files, the minutiae JSON schema, ``roc.png``, and the EER and mean
    gap bounds of ``tests/test_end_to_end_eer.py``. Returns the stage
    launches and seconds."""
    import os
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch import pipeline
    from multimodal_biometric_fingerprints_palms_tpu_torch.catalog import (
        CATALOG_COLUMNS)
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        runner as frun)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        runner as mrun)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        runner as prun)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.io import (
        read_image_grayscale)

    launches = {}

    def counted(name, fn):
        def run(*args, **kwargs):
            for k in build.LAUNCHES:
                build.LAUNCHES[k] = 0
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            launches[name] = dict(build.LAUNCHES)
            return out
        return run

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        files = load_tool("polyu_set").write(root, FILE_SUBJECTS)
        t_data = time.perf_counter() - t0
        # run_all imports each stage's entry point when it reaches it: wrap
        # them in their modules to count each stage's launches alone
        stages = [(prun, "run_preprocessing", "preprocessing"),
                  (frun, "process_directory", "features"),
                  (mrun, "main", "matching")]
        saved = [getattr(m, n) for m, n, _ in stages]
        try:
            for m, n, label in stages:
                setattr(m, n, counted(label, getattr(m, n)))
            os.chdir(root)
            t0 = time.perf_counter()
            res = pipeline.run_all(str(root), skip_ssl=True,
                                   demo_matching=False)
            t_all = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            for (m, n, _), fn in zip(stages, saved):
                setattr(m, n, fn)

        readable = sorted(r for r, kind in files.items() if kind != ".tif")
        pre, feat, mat = (res["preprocessing"], res["features"],
                          res["matching"])
        print(f"  {len(files)} files written in {t_data:.2f} s; run_all "
              f"{t_all:.2f} s: catalog rows {res['catalog_rows']}, "
              f"preprocessed {pre['num_images']} (reader {pre['reader']}), "
              f"minutiae {feat['num_images']}, {mat['num_users']} users, "
              f"{mat['genuine_pairs']} genuine + {mat['impostor_pairs']} "
              f"impostor pairs")
        if not (res["catalog_rows"] == pre["num_images"] == feat["num_images"]
                == len(readable)):
            fail(f"file pipeline: expected {len(readable)} images at every "
                 f"stage, got catalog {res['catalog_rows']}, preprocessing "
                 f"{pre['num_images']}, features {feat['num_images']}")
        with open(root / "data" / "metadata" / "catalog.csv") as f:
            lines = f.read().splitlines()
        if lines[0].split(",") != CATALOG_COLUMNS or len(lines) != len(readable) + 1:
            fail("file pipeline: catalog header or row count")

        # every output file, and the minutiae JSON schema
        missing = []
        for rel in readable:
            sub, name = rel.rsplit("/", 1)
            base = Path(name).stem
            want = [f"processed/enhanced/{sub}/{base}_{k}.jpg"
                    for k in ("enhanced", "skeleton")]
            want += [f"processed/debug/{sub}/{base}_{k}.jpg" for k in (
                "normalized", "denoised", "segmented", "binary")]
            want += [f"processed/debug/{sub}/mask/{name}",
                     f"processed/minutiae/{sub}/{base}_minutiae.jpg",
                     f"processed/minutiae/{sub}/{base}_minutiae.json"]
            missing += [w for w in want if not (root / w).is_file()]
        logs = root / "logs"
        missing += [f"logs/{n}" for n in ("minutiae_stats.csv",
                                          "genuine_match_stats.csv", "roc.png")
                    if not (logs / n).is_file()]
        if missing:
            fail(f"file pipeline: {len(missing)} outputs missing, e.g. "
                 f"{missing[:3]}")
        n_min = []
        for p in sorted((root / "processed" / "minutiae").rglob("*.json")):
            recs = json.loads(p.read_text())
            n_min.append(len(recs))
            if any(set(r) != REFERENCE_KEYS or r["type"] not in (
                    "ending", "bifurcation") or not isinstance(r["x"], int)
                    for r in recs):
                fail(f"file pipeline: {p.name} breaks the reference schema")
        roc = read_image_grayscale(logs / "roc.png")
        print(f"  every output present; minutiae per template min "
              f"{min(n_min)}, median {int(np.median(n_min))}, max "
              f"{max(n_min)}; roc.png {roc.shape[1]}x{roc.shape[0]}")

        # launches per stage: one run_preprocessing batch is A x3, B x4 and
        # C, E, F, G x1; matching launches D only
        n_batches = -(-pre["num_images"] // 32)
        per_batch = {"clahe": 3, "cc": 4, "thin": 1, "match": 0, "nlm": 1,
                     "binarize": 1, "morph": 1}
        got = {k: launches["preprocessing"][k] for k in per_batch}
        print(f"  launches: preprocessing {got} ({n_batches} batches); "
              f"features {({k: launches['features'][k] for k in per_batch})}; "
              f"matching {({k: launches['matching'][k] for k in per_batch})}")
        if got != {k: v * n_batches for k, v in per_batch.items()}:
            fail("file pipeline: preprocessing launch counts")
        if launches["matching"]["match"] <= 0 or any(
                launches["matching"][k] for k in per_batch if k != "match"):
            fail("file pipeline: matching launch counts")

        # card against the CPU port on the same files
        cmp_dir = root / "cmp" / "sorted_dataset" / "cluster_0"
        cmp_dir.mkdir(parents=True)
        picked = readable[:FILE_CMP]
        for rel in picked:
            (cmp_dir / Path(rel).name).write_bytes(
                (root / "sorted_dataset" / rel).read_bytes())
        os.chdir(root)
        try:
            prun.run_preprocessing(root / "cmp" / "sorted_dataset",
                                   root / "cmp" / "processed", device="cpu")
            frun.process_directory(root / "cmp" / "processed" / "enhanced",
                                   root / "cmp" / "processed" / "minutiae",
                                   device="cpu")
        finally:
            os.chdir(cwd)
        mism = total = 0
        dcount = []
        for rel in picked:
            sub, name = rel.rsplit("/", 1)
            base = Path(name).stem
            a = read_image_grayscale(
                root / f"processed/enhanced/{sub}/{base}_skeleton.jpg") > 127
            b = read_image_grayscale(
                root / f"cmp/processed/enhanced/cluster_0/{base}_skeleton.jpg") > 127
            mism += int((a != b).sum())
            total += int(b.sum())
            na = len(json.loads((root / f"processed/minutiae/{sub}/"
                                 f"{base}_minutiae.json").read_text()))
            nb = len(json.loads((root / f"cmp/processed/minutiae/cluster_0/"
                                 f"{base}_minutiae.json").read_text()))
            dcount.append(abs(na - nb))
        print(f"  card vs CPU port from the same files, {FILE_CMP} images: "
              f"skeleton mismatches {mism} of {total} skeleton px; "
              f"valid-count diffs {dcount}")
        if mism > MAX_SKEL_MISMATCH * total or max(dcount) > MAX_COUNT_DIFF:
            fail("file pipeline: card and CPU port disagree beyond the bound")

    g, imp = mat["genuine_scores"], mat["impostor_scores"]
    gap = float(g.mean() - imp.mean())
    print(f"  EER {mat['eer']:.4f} (<= 0.13), genuine mean {g.mean():.4f}, "
          f"impostor mean {imp.mean():.4f}, gap {gap:.4f} (>= 0.3)")
    if not (np.isfinite(g).all() and np.isfinite(imp).all()):
        fail("file pipeline: non-finite scores")
    if mat["eer"] > 0.13 or gap < 0.3:
        fail("file pipeline: EER or genuine-impostor gap outside the bounds")

    ps, fs = pre["seconds"], feat["seconds"]
    seconds = {
        "catalog": res["seconds"]["catalog"],
        **{f"preprocessing {k}": v for k, v in ps.items()},
        **{f"features {k}": v for k, v in fs.items()},
        "matching": res["seconds"]["matching"]}
    print(f"  stage seconds on {card}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items())
        + f"; file path {pre['num_images'] / t_all:.1f} img/s over run_all "
        f"({t_all:.2f} s); preprocessing reader: {pre['reader']}")
    return dict(launches=launches, seconds=seconds, run_all_s=t_all,
                reader=pre["reader"])


# --- the formats: every image file the JAX package reads ---------------------

FORMATS_DIR = ROOT / "tests" / "fixtures" / "formats"
# the print fixtures (tools/format_fixtures.py) and what stands in for each
# in the all-baseline twin run: the JPEGs their baseline twin, the lossless
# files a PNG the port writes from their pixels
FORMAT_PRINTS = ["progressive.jpg", "progressive_colour.jpg", "none.tif",
                 "deflate.tif", "packbits.tif", "grey16.png", "palette.png",
                 "adam7.png", "bmp32.bmp", "rle8.bmp", "exif_o6.png",
                 "exif_o3.tif", "lzw.tif"]
FORMAT_SUBJECTS = (1, 2, 3, 4)


def _reader_kind(name: str) -> str:
    """The reader a fixture exercises, for the per-format times."""
    stem = Path(name).name
    if name.startswith("prints/"):
        return "print " + stem
    if stem.startswith("jpeg_progressive"):
        return "progressive JPEG"
    if stem.startswith("jpeg_baseline"):
        return "baseline colour JPEG"
    return {".jpg": "JPEG (Exif)", ".png": "PNG", ".bmp": "BMP",
            ".tif": "TIFF"}[Path(stem).suffix]


def formats_phase(dev, build, card) -> dict:
    """Every file of ``tests/fixtures/formats`` through the port's codec,
    grey and RGB, held to OpenCV's digests in ``expected.json`` (times a
    file by reader on the host); then ``pipeline.run_all(skip_ssl=True)``
    on the card over a 16-subject tree whose subjects 1 to 4 hold the print
    fixtures (progressive and colour JPEG, TIFF without compression, with
    Deflate, PackBits, and LZW written by the port, 16-bit, palette and
    Adam7 PNG, 32-bit and RLE8 BMP, a PNG and a TIFF turned by their
    orientation), and over its twin tree (each JPEG's baseline twin, each
    lossless file a PNG of its pixels, the LZW TIFF the JPEG it was
    decoded from). Fails unless only the corrupt TIFF is skipped, each
    format file's minutiae JSON and debug mask equal its twin's, and the
    EERs and scores are equal. One ``visualize_orientation`` on a 320x256
    print is timed too."""
    import hashlib
    import os
    import shutil
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch import pipeline
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.orientation import (
        compute_orientation_field)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.visualize import (
        visualize_orientation)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
        image_codec as codec)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        blob_prints)

    t_phase = time.perf_counter()
    expected = json.loads((FORMATS_DIR / "expected.json").read_text())
    times: dict = {}
    bad = []
    for name in sorted(expected):
        data = (FORMATS_DIR / name).read_bytes()
        t0 = time.perf_counter()
        g = codec.decode_gray(data, name)
        t1 = time.perf_counter()
        c = codec.decode_rgb(data, name)
        t2 = time.perf_counter()
        times.setdefault(_reader_kind(name), []).append(
            ((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        for kind, img in (("gray", g), ("rgb", c)):
            want = expected[name][kind]
            got = {"shape": list(img.shape), "sha256": hashlib.sha256(
                np.ascontiguousarray(img).tobytes()).hexdigest()}
            if got != want:
                bad.append(f"{name} {kind}")
    reader_ms = {k: {"files": len(v),
                     "gray_ms": float(np.mean([a for a, _ in v])),
                     "rgb_ms": float(np.mean([b for _, b in v]))}
                 for k, v in sorted(times.items())}
    print(f"  {len(expected)} fixture files decoded grey and RGB; "
          f"{len(expected) - len({b.split()[0] for b in bad})} equal "
          "OpenCV's digests")
    for k, v in reader_ms.items():
        print(f"    {k}: {v['files']} files, grey {v['gray_ms']:.2f} ms, "
              f"RGB {v['rgb_ms']:.2f} ms a file (host, {card})")
    if bad:
        fail(f"formats: {len(bad)} decodes differ from OpenCV's, e.g. "
             f"{bad[:3]}")

    cwd = os.getcwd()
    polyu_set = load_tool("polyu_set")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        trees = {"formats": root / "formats", "twins": root / "twins"}
        files = polyu_set.write(trees["formats"], FILE_SUBJECTS)
        shutil.copytree(trees["formats"] / "sorted_dataset",
                        trees["twins"] / "sorted_dataset")
        by_subject = {s: sorted(r for r in files
                                if Path(r).name.split("_")[0] == str(s))
                      for s in FORMAT_SUBJECTS}
        slots = [by_subject[s][k] for k in range(4)
                 for s in FORMAT_SUBJECTS][:len(FORMAT_PRINTS)]
        placed = {}
        for rel, kind in zip(slots, FORMAT_PRINTS):
            stem = rel[:-4]
            orig = trees["formats"] / "sorted_dataset" / rel
            ext = Path(kind).suffix
            if kind == "lzw.tif":
                data = codec.encode_for("x.tif", codec.read_gray(orig))
                twin, twin_ext = orig.read_bytes(), ".jpg"
            else:
                data = (FORMATS_DIR / "prints" / kind).read_bytes()
                if ext == ".jpg":
                    twin = (FORMATS_DIR / "prints" / f"base_{kind}").read_bytes()
                    twin_ext = ".jpg"
                else:
                    twin = codec.encode_png(codec.decode_gray(data, kind))
                    twin_ext = ".png"
            for tree, payload, e in (("formats", data, ext),
                                     ("twins", twin, twin_ext)):
                d = trees[tree] / "sorted_dataset"
                (d / rel).unlink()
                (d / (stem + e)).write_bytes(payload)
            placed[kind] = (stem, ext, twin_ext)
        runs = {}
        for tree, path in trees.items():
            for k in build.LAUNCHES:
                build.LAUNCHES[k] = 0
            os.chdir(path)
            try:
                res, t_all = wall_s(lambda: pipeline.run_all(
                    str(path), skip_ssl=True, demo_matching=False))
            finally:
                os.chdir(cwd)
            runs[tree] = dict(res=res, t=t_all, launches=dict(build.LAUNCHES))
        fmt, twn = runs["formats"]["res"], runs["twins"]["res"]
        n_files = len(files) - 1                    # all but the corrupt TIFF
        print(f"  run_all over the formats tree {runs['formats']['t']:.2f} s, "
              f"over its twins {runs['twins']['t']:.2f} s: preprocessed "
              f"{fmt['preprocessing']['num_images']} and "
              f"{twn['preprocessing']['num_images']} of {len(files)} files; "
              f"launches (formats tree) {runs['formats']['launches']}")
        if not (fmt["catalog_rows"] == fmt["preprocessing"]["num_images"]
                == fmt["features"]["num_images"] == n_files
                == twn["preprocessing"]["num_images"]):
            fail("formats: a file other than the corrupt TIFF was skipped")
        unequal = []
        for kind, (stem, ext, twin_ext) in placed.items():
            sub, base = stem.rsplit("/", 1)
            a = (trees["formats"] / "processed" / "minutiae" / sub
                 / f"{base}_minutiae.json").read_text()
            b = (trees["twins"] / "processed" / "minutiae" / sub
                 / f"{base}_minutiae.json").read_text()
            # a mask written as JPEG (a JPEG input's) is read back through
            # its threshold
            ma = codec.read_gray(trees["formats"] / "processed" / "debug" / sub
                                 / "mask" / f"{base}{ext}") > 127
            mb = codec.read_gray(trees["twins"] / "processed" / "debug" / sub
                                 / "mask" / f"{base}{twin_ext}") > 127
            n = len(json.loads(a))
            if a != b or not np.array_equal(ma, mb):
                unequal.append(kind)
            print(f"    {kind:24s} {stem}{ext}: {n} minutiae, JSON and mask "
                  f"{'equal' if kind not in unequal else 'DIFFER'} to the "
                  f"twin's")
        if unequal:
            fail(f"formats: templates differ from their twins': {unequal}")
        mf, mt = fmt["matching"], twn["matching"]
        same = (mf["eer"] == mt["eer"]
                and np.array_equal(mf["genuine_scores"], mt["genuine_scores"])
                and np.array_equal(mf["impostor_scores"],
                                   mt["impostor_scores"]))
        print(f"  EER {mf['eer']:.4f} over the formats tree, {mt['eer']:.4f} "
              f"over the twins; scores equal: {same}")
        if not same:
            fail("formats: EER or scores differ from the all-baseline run")

    img = blob_prints([5], None, 320, 256)[0].astype(np.float32)
    field = compute_orientation_field(torch.from_numpy(img)[None].to(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vis = visualize_orientation(img, field.orientation[0],
                                reliability_img=field.reliability[0],
                                mask=torch.from_numpy(img > 0.3))
    vis_ms = (time.perf_counter() - t0) * 1e3
    if vis.shape != (320, 256, 3) or vis.dtype != np.uint8:
        fail("formats: visualize_orientation output")
    print(f"  visualize_orientation on a 320x256 print: {vis_ms:.1f} ms "
          f"(host, {card})")
    t_phase = time.perf_counter() - t_phase
    print(f"  formats phase {t_phase:.1f} s")
    return dict(launches=runs["formats"]["launches"], reader_ms=reader_ms,
                run_all_s=runs["formats"]["t"], twin_run_all_s=runs["twins"]["t"],
                eer=mf["eer"], visualize_orientation_ms=vis_ms,
                seconds=t_phase)


# --- the gallery: all-pairs scoring and 1:N identification --------------------

# the README's all-pairs protocol, PolyU DBII's shape: 148 users x 10
# samples (utils.synthetic.users_gallery, a copy of the matcher benchmark's)
GALLERY_USERS, GALLERY_SAMPLES = 148, 10
GALLERY_CHUNK = 2048          # full-pass pairs a call (all_pairs_unique's)
GALLERY_BLOCK = 64            # the blocked screen's tile side
GALLERY_WARMUP = 256          # templates of the warm-up sweep (bench_allpairs)
GALLERY_CMP = 64              # templates matched on the card and on the CPU
CMP_ITERS, CMP_SCREEN_ITERS = 32, 8       # their full pass and screen
IDENT_CHUNK = 512
IDENT_PROBES = 64
GALLERY_SCORE_ATOL = 1e-6     # cascade vs full pass, card vs CPU


def gallery_phase(dev, build, card, mesh) -> dict:
    """The port's gallery (``parallel/``) on ``mesh``: the all-pairs sweep
    of 1,480 templates at the production budget (RANSAC 300) with the
    cascade off, on, and on without its anchors; kernel D against its twin
    on a screen tile's shape; 64 templates on the mesh against the CPU; the
    screen's recall at ``min_inliers=6`` on 12-minutia templates; and
    ``identify`` / ``identify_batch`` against the gallery padded to 1,536.
    The galleries are built on the CPU, so the mesh alone puts the sweeps on
    its device. Each sweep's kernel launches are counted alone. Returns
    kernel D's launches in the cascade sweep."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet, minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams, _pair_stats, sample_hypotheses)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
        gallery as G)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        users_gallery)

    t_phase = time.perf_counter()
    n = GALLERY_USERS * GALLERY_SAMPLES
    labels = np.repeat(np.arange(GALLERY_USERS), GALLERY_SAMPLES)
    pairs = G.unique_pairs(n)
    same = labels[pairs[:, 0]] == labels[pairs[:, 1]]
    nb = -(-n // GALLERY_BLOCK)
    tiles = nb * (nb + 1) // 2
    chunks = lambda k: -(-k // GALLERY_CHUNK)
    gib = lambda b: b / 2 ** 30
    print(f"  {n} templates ({GALLERY_USERS} users x {GALLERY_SAMPLES}), "
          f"{len(pairs)} unique pairs, {int(same.sum())} genuine; mesh "
          f"{mesh.devices}; screen: {tiles} tiles of {GALLERY_BLOCK ** 2} pairs")

    def screen_params(params, iters):
        """all_pairs_unique's screen parameters for a full pass ``params``."""
        return params._replace(ransac_iter=iters, full_iters=params.ransac_iter,
                               min_inliers=max(3, params.min_inliers - 2))

    def promoted_slots(gal, params, anchors):
        """(P,) bool over ``pairs``: the blocked screen's promote bits, laid
        out tile by tile on the (N, N) grid and read at each unique pair."""
        bp, mask = G.shard_blocks_screen(
            gal, mesh, screen_params(params, SCREEN_ITERS),
            block=GALLERY_BLOCK, anchors=anchors)
        side = nb * GALLERY_BLOCK
        grid = np.zeros((side, side), bool)
        tile = lambda i: slice(i * GALLERY_BLOCK, (i + 1) * GALLERY_BLOCK)
        for (bi, bj), bits in zip(bp, mask):
            grid[tile(bi), tile(bj)] = bits.reshape(GALLERY_BLOCK, GALLERY_BLOCK)
        return grid[pairs[:, 0], pairs[:, 1]]

    def sweep(name, gal, params, cascade, anchors=True):
        """all_pairs_unique on ``gal``, counted, timed and checked; the
        screen's promote bits are taken after the timed call."""
        for key in build.LAUNCHES:
            build.LAUNCHES[key] = 0
        torch.cuda.reset_peak_memory_stats()
        scores, secs = wall_s(lambda: G.all_pairs_unique(
            gal, mesh, params, chunk=GALLERY_CHUNK, cascade=cascade,
            screen_iters=SCREEN_ITERS, anchors=anchors))
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        promoted = promoted_slots(gal, params, anchors) if cascade else None
        want = (tiles + chunks(int(promoted.sum())) if cascade
                else chunks(len(pairs)))
        g_mean, i_mean = scores[same].mean(), scores[~same].mean()
        share = (f"promoted {int(promoted.sum())} ({promoted.mean():.4%}); "
                 if cascade else "")
        print(f"  {name}: {secs:.3f} s, {len(pairs) / secs:.1f} pairs/s; "
              f"{share}kernel D launches {launches['match']} (expected "
              f"{want}); peak device memory {gib(peak):.3f} GiB; genuine "
              f"mean {g_mean:.4f}, impostor mean {i_mean:.6f}")
        if launches != {**dict.fromkeys(build.LAUNCHES, 0), "match": want}:
            fail(f"gallery {name}: launch counts {launches}, expected {want} "
                 "kernel-D calls and nothing else")
        if scores.shape != (len(pairs),) or not np.isfinite(scores).all():
            fail(f"gallery {name}: scores' shape or values")
        if cascade and (scores[~promoted] != 0).any():
            fail(f"gallery {name}: a pair the screen dropped scored > 0")
        if not g_mean > i_mean + 0.2:
            fail(f"gallery {name}: genuine mean {g_mean:.4f} is not above the "
                 f"impostor mean {i_mean:.4f} by 0.2")
        return dict(scores=scores, seconds=secs, launches=launches["match"],
                    peak_bytes=peak, promoted=promoted)

    def agree(name, cascaded, full):
        """Every cascade score is 0 or the full pass's score of that pair."""
        kept = cascaded != 0.0
        d = np.abs(cascaded[kept] - full[kept])
        worst = float(d.max()) if d.size else 0.0
        print(f"  {name}: {int(kept.sum())} pairs scored > 0, "
              f"{int((d != 0).sum())} of them not bit-equal to the full pass "
              f"(max |d| {worst:.3g})")
        if worst > GALLERY_SCORE_ATOL:
            fail(f"gallery {name}: cascade scores differ from the full pass")

    # 1. the all-pairs sweep, three modes, each after a warm-up sweep of the
    # first 256 templates. The gallery lies on the CPU: the mesh moves it.
    g40 = minutiae_from_numpy(users_gallery(GALLERY_USERS, GALLERY_SAMPLES,
                                            n_min=40, seed=0))
    warm = MinutiaeSet(*(x[:GALLERY_WARMUP] for x in g40))
    p = MatchParams(ransac_iter=H_FULL)
    print(f"all-pairs sweep, users_gallery({GALLERY_USERS}, "
          f"{GALLERY_SAMPLES}, n_min=40), RANSAC {H_FULL}, chunk "
          f"{GALLERY_CHUNK}, on {card}:")
    runs = {}
    for name, cascade, anchors in (("cascade off", False, True),
                                   ("cascade on", True, True),
                                   ("cascade on, anchors off", True, False)):
        G.all_pairs_unique(warm, mesh, p, chunk=GALLERY_CHUNK,
                           cascade=cascade, screen_iters=SCREEN_ITERS,
                           anchors=anchors)
        runs[name] = sweep(name, g40, p, cascade, anchors)
    for name in ("cascade on", "cascade on, anchors off"):
        agree(name, runs[name]["scores"], runs["cascade off"]["scores"])

    # 2. kernel D against its twin on the screen's first tile, block pair
    # (0, 0): 4,096 pairs (eight 512-pair slices, one a row of A's 8) of
    # 6.4 users, at the screen's parameters. The hypotheses' uniforms are
    # the same for every pair, so one user's pairs tend to hit or miss
    # together: a slice of one user can hold no score > 0 at all.
    screen_p = screen_params(p, SCREEN_ITERS)
    gd = G.shard_gallery(g40, mesh)
    k = torch.arange(GALLERY_BLOCK ** 2, device=dev)
    a = G.take_templates(gd, k // GALLERY_BLOCK)
    b = G.take_templates(gd, k % GALLERY_BLOCK)
    wa, wb, _, _, possible, _ = _pair_stats(a, b)
    args = (a, b, wa, wb, *sample_hypotheses(a, b, wa, wb, screen_p),
            possible, screen_p)
    sk, ck = cm.hypothesis_scores_cuda(*args)
    sp, cp = cm.hypothesis_scores_plain(*args)
    bad, err = int((ck != cp).sum()), float((sk - sp).abs().max())
    slices = (sk.reshape(-1, CHUNK, SCREEN_ITERS) > 0).flatten(1).any(dim=1)
    print(f"kernel D on the screen's tile (0, 0) (P={GALLERY_BLOCK ** 2}, "
          f"H={SCREEN_ITERS}): count mismatches {bad} / {ck.numel()}, "
          f"max|ds| {err:.3g}; scores > 0 {int((sk > 0).sum())}, in "
          f"{int(slices.sum())} of its {len(slices)} 512-pair slices")
    if bad or err > D_ATOL or int((sk > 0).sum()) == 0:
        fail("kernel D differs from its twin on a screen tile (or no score > 0)")

    # 3. the first 64 templates on the mesh and on the CPU, cascade on: the
    # screen's mask and the full pass's scores, one CPU gallery for both
    cpu = create_mesh(device="cpu")
    small = MinutiaeSet(*(x[:GALLERY_CMP] for x in g40))
    p32 = MatchParams(ransac_iter=CMP_ITERS)
    got = {}
    for where, m in (("card", mesh), ("CPU", cpu)):
        s, secs = wall_s(lambda: G.all_pairs_unique(
            small, m, p32, chunk=GALLERY_CHUNK, cascade=True,
            screen_iters=CMP_SCREEN_ITERS))
        _, bits = G.shard_blocks_screen(
            small, m, screen_params(p32, CMP_SCREEN_ITERS),
            block=GALLERY_BLOCK)
        got[where] = (s, bits, secs)
    (s_card, m_card, t_card), (s_cpu, m_cpu, t_cpu) = got["card"], got["CPU"]
    bad_mask = int((m_card != m_cpu).sum())
    err = float(np.abs(s_card - s_cpu).max())
    print(f"{GALLERY_CMP} templates, RANSAC {CMP_ITERS} with the cascade "
          f"(screen {CMP_SCREEN_ITERS}), card vs CPU: mask mismatches {bad_mask} / "
          f"{m_card.size} ({int(m_card.sum())} promoted), max|ds| {err:.3g} "
          f"over {len(s_card)} pairs ({int((s_card > 0).sum())} > 0); "
          f"{t_card:.3f} s on the card, {t_cpu:.3f} s on the CPU")
    if bad_mask or err > GALLERY_SCORE_ATOL:
        fail("gallery: the card and the CPU disagree")

    # 4. the screen's recall at the production budget (VERDICT weak #6):
    # 12-minutia templates, min_inliers 6
    g12 = minutiae_from_numpy(users_gallery(GALLERY_USERS, GALLERY_SAMPLES,
                                            n_min=12, seed=0))
    p6 = MatchParams(ransac_iter=H_FULL, min_inliers=6)
    print(f"screen recall, users_gallery({GALLERY_USERS}, {GALLERY_SAMPLES}, "
          f"n_min=12), RANSAC {H_FULL}, min_inliers 6:")
    on = sweep("cascade on", g12, p6, True)
    off = sweep("cascade off", g12, p6, False)
    agree("cascade on", on["scores"], off["scores"])
    recall = {}
    for kind, sel in (("genuine", same), ("impostor", ~same)):
        row = dict(pairs=int(sel.sum()),
                   promoted=int(on["promoted"][sel].sum()),
                   scored_cascade=int((on["scores"][sel] > 0).sum()),
                   scored_full=int((off["scores"][sel] > 0).sum()),
                   lost=int(((off["scores"] > 0) & ~on["promoted"])[sel].sum()))
        recall[kind] = row
        print(f"  {kind}: {row['pairs']} pairs, promoted {row['promoted']}, "
              f"score > 0 with the cascade {row['scored_cascade']}, without "
              f"{row['scored_full']}, > 0 without it but dropped by the "
              f"screen {row['lost']}")

    # 5. identification against the gallery padded to a multiple of 512,
    # placed on the mesh once
    gp = G.pad_gallery(gd, IDENT_CHUNK)
    n_gp = gp.valid.shape[0]
    print(f"identification, {n_gp} templates (padded), chunk {IDENT_CHUNK}, "
          f"RANSAC {H_FULL}:")
    probe = MinutiaeSet(*(x[3] for x in gd))
    G.identify(probe, gp, mesh, p, chunk=IDENT_CHUNK)
    reps = 3
    torch.cuda.reset_peak_memory_stats()
    for key in build.LAUNCHES:
        build.LAUNCHES[key] = 0
    _, secs = wall_s(lambda: [G.identify(probe, gp, mesh, p, chunk=IDENT_CHUNK)
                              for _ in range(reps)])
    one_ms = secs / reps * 1e3
    one_launches = build.LAUNCHES["match"] // reps
    one_peak = torch.cuda.max_memory_allocated()
    probes = G.take_templates(gd, torch.arange(IDENT_PROBES, device=dev))
    batch = G.identify_batch(probes, gp, mesh, p, chunk=IDENT_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    for key in build.LAUNCHES:
        build.LAUNCHES[key] = 0
    _, secs = wall_s(lambda: G.identify_batch(probes, gp, mesh, p,
                                              chunk=IDENT_CHUNK))
    batch_ms = secs / IDENT_PROBES * 1e3
    batch_launches = build.LAUNCHES["match"]
    batch_peak = torch.cuda.max_memory_allocated()
    per_call = max(1, G._PAIR_BATCH // IDENT_CHUNK)
    want_one = n_gp // IDENT_CHUNK
    want_batch = want_one * -(-IDENT_PROBES // per_call)
    print(f"  identify: {one_ms:.3f} ms/probe over {reps} synchronized calls, "
          f"kernel D launches {one_launches} a probe (expected {want_one}), "
          f"peak device memory {gib(one_peak):.3f} GiB")
    print(f"  identify_batch, {IDENT_PROBES} probes: {batch_ms:.3f} ms/probe "
          f"({secs:.3f} s a call), kernel D launches {batch_launches} "
          f"(expected {want_batch}), peak device memory "
          f"{gib(batch_peak):.3f} GiB")
    if (one_launches, batch_launches) != (want_one, want_batch):
        fail("identification: kernel D launch counts")
    if batch.shape != (IDENT_PROBES, n_gp) or not torch.isfinite(batch).all():
        fail("identify_batch: shape or values")
    others = batch.clone()
    rows = torch.arange(IDENT_PROBES, device=dev)
    others[rows, rows] = -1.0                   # the probe's own template
    top_self = batch.argmax(dim=1).cpu().numpy()
    top = others.argmax(dim=1).cpu().numpy()
    right = int((labels[top] == labels[:IDENT_PROBES]).sum())
    print(f"  top-1 user right for {right} of {IDENT_PROBES} probes with "
          f"each probe's own template left out (its own template ranks "
          f"first for {int((top_self == np.arange(IDENT_PROBES)).sum())})")
    if right != IDENT_PROBES:
        fail("identify_batch: a probe's top-1 user is wrong")
    for i in (0, 1, IDENT_PROBES - 1):
        row = G.identify(MinutiaeSet(*(x[i] for x in gd)), gp, mesh, p,
                         chunk=IDENT_CHUNK)
        if not torch.equal(row, batch[i]):
            fail(f"identify(probe {i}) differs from row {i} of identify_batch "
                 f"(max|d| {float((row - batch[i]).abs().max()):.3g})")
    print(f"  identify(probe i) equals row i of identify_batch for i = 0, 1, "
          f"{IDENT_PROBES - 1}")
    t_phase = time.perf_counter() - t_phase
    print(f"  gallery phase {t_phase:.2f} s on {card}")
    return dict(launches=runs["cascade on"]["launches"], seconds=t_phase,
                sweeps={k: v["seconds"] for k, v in runs.items()},
                recall=recall, identify_ms=one_ms,
                identify_batch_ms=batch_ms)


# --- the SSL front: models, segmentation, run_all from a raw tree -------------

SSL_FULL = dict(backbone_name="effnetv2_s", embedding_dim=756,
                proj_hidden_dim=512, proj_output_dim=256)
SSL_BATCHES = ((16, 20), (128, 5))      # (batch of 224x224, timed runs)
SSL_CMP = 8                   # images run on the card and on the CPU
# card vs CPU port, L2-normalised embeddings, float32 with TF32 off: the
# two devices sum each convolution in their own order
SSL_ATOL = 1e-4
UNET_FULL = (64, 128, 256, 512, 1024)
UNET_BATCHES = ((1, 20), (4, 10))       # (batch of 256x256, timed runs)
UNET_PROB_ATOL = 1e-4         # sigmoid, card vs CPU port
UNET_BAND = 1e-4              # masks may differ only this near 0.5
RAW_SUBJECTS = 16             # PolyU-named JPEGs under DBII/, x 10
RAW_NIST = 4                  # NIST-named PNGs under Nist/, x 2
COASSIGN_MIN = 0.99           # id_clusters.csv, card vs CPU port


def ssl_forward_phase(dev, card) -> dict:
    """The full-width SSL model (seeded weights) through the port's
    checkpoint writer and reader, bit-equal after it; img/s at batch 16 and
    128 on 224x224 (CUDA events over synchronized runs after a warm-up) and
    peak device memory; 8 images on the card against the port on the CPU
    (both L2-normalised outputs within SSL_ATOL); ``entry()`` once."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.entry import entry
    from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
        SSLModel, load_jax_variables, seed_weights, ssl_variables_from_state)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
        load_msgpack, save_msgpack)
    cpu_model = seed_weights(SSLModel(**SSL_FULL), 42).eval()
    v = ssl_variables_from_state(cpu_model.state_dict())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = save_msgpack(Path(tmp) / "ssl_model_final.msgpack",
                            {"params": v["params"],
                             "batch_stats": v["batch_stats"], "step": 0})
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        payload = load_msgpack(path)
        t_read = time.perf_counter() - t0
        mb = path.stat().st_size / 2 ** 20
    model = load_jax_variables(SSLModel(**SSL_FULL), {
        "params": payload["params"], "batch_stats": payload["batch_stats"]})
    ref = cpu_model.state_dict()
    differ = [k for k, t in model.state_dict().items()
              if not torch.equal(t, ref[k])]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  checkpoint: {mb:.1f} MiB, {n_params} parameters, written in "
          f"{t_write:.2f} s, read in {t_read:.2f} s; tensors that differ "
          f"after the round trip {len(differ)} of {len(ref)}")
    if differ:
        fail(f"SSL checkpoint round trip changed {differ[:3]}")
    model = model.to(dev).eval()
    g = np.random.default_rng(0)
    rates = {}
    with torch.no_grad():
        for batch, reps in SSL_BATCHES:
            x = torch.from_numpy(g.random((batch, 224, 224), np.float32)).to(dev)
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: model(x, return_embedding=True), reps)
            peak = torch.cuda.max_memory_allocated()
            rates[batch] = dict(ms=ms, img_s=batch * 1e3 / ms, peak_bytes=peak)
            print(f"  batch {batch} x 224x224: {ms:.3f} ms a forward -> "
                  f"{batch * 1e3 / ms:.1f} img/s, peak device memory "
                  f"{peak / 2 ** 20:.1f} MiB ({card})")
        x = torch.from_numpy(g.random((SSL_CMP, 224, 224), np.float32))
        p_card, e_card = (t.cpu() for t in model(x.to(dev), return_embedding=True))
        p_cpu, e_cpu = cpu_model(x, return_embedding=True)
        unit = lambda t: t / t.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        err_p = float((unit(p_card) - unit(p_cpu)).abs().max())
        err_e = float((e_card - e_cpu).abs().max())
        print(f"  card vs CPU port, {SSL_CMP} images: L2-normalised predictor "
              f"output max |d| {err_p:.3g}, backbone embedding {err_e:.3g} "
              f"(bound {SSL_ATOL:g})")
        if not (err_p <= SSL_ATOL and err_e <= SSL_ATOL):
            fail("SSL forward: card and CPU port differ beyond the bound")
        fn, (ex,) = entry()
        out = fn(ex)
        torch.cuda.synchronize()
    print(f"  entry(): {tuple(out.shape)} on {out.device}, finite "
          f"{bool(torch.isfinite(out).all())}")
    if out.shape != (8, 256) or not torch.isfinite(out).all():
        fail("entry() output shape or values")
    return dict(rates=rates, err_pred=err_p, err_emb=err_e,
                checkpoint_mib=mb)


def unet_phase(dev, card) -> dict:
    """UNet++ at the config's filters (64 .. 1024): ms per 256x256 image at
    batch 1 and 4, peak memory; 2 images on the card against the port on
    the CPU (probabilities within UNET_PROB_ATOL, masks equal off the
    UNET_BAND around 0.5); ``segment_images`` on the card over 4 files with
    a checkpoint this phase writes (its output layer set so that a print's
    logits have mean 0 and std 2: both classes occur)."""
    import copy
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
        NestedUNet, seed_weights, unet_variables_from_state)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        segmentation_infer)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import cvcompat
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
        save_msgpack)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        encode_jpeg)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.io import (
        read_image_grayscale)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        blob_prints)
    prints = blob_prints([31, 32, 33, 34], None, 320, 240)
    stacked = [np.stack([cvcompat.resize(p, (256, 256), cvcompat.INTER_AREA)] * 3)
               for p in prints]
    cpu_model = seed_weights(NestedUNet(UNET_FULL), 7).eval()
    with torch.no_grad():
        logits = cpu_model(torch.from_numpy(stacked[0][None]))
        scale = 2.0 / logits.std()
        cpu_model.Conv_0.weight *= scale
        cpu_model.Conv_0.bias.copy_((cpu_model.Conv_0.bias - logits.mean()) * scale)
    model = copy.deepcopy(cpu_model).to(dev)
    g = np.random.default_rng(1)
    rates = {}
    with torch.no_grad():
        for batch, reps in UNET_BATCHES:
            x = torch.from_numpy(g.random((batch, 3, 256, 256), np.float32)).to(dev)
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: model(x), reps)
            peak = torch.cuda.max_memory_allocated()
            rates[batch] = dict(ms_per_image=ms / batch, peak_bytes=peak)
            print(f"  batch {batch} x 256x256: {ms / batch:.3f} ms an image, "
                  f"peak device memory {peak / 2 ** 20:.1f} MiB ({card})")
        x = torch.from_numpy(np.stack(stacked[:2]))
        pc = torch.sigmoid(model(x.to(dev))).cpu()
        pr = torch.sigmoid(cpu_model(x))
    err = float((pc - pr).abs().max())
    band = (pr - 0.5).abs() < UNET_BAND
    off = int(((pc > 0.5) != (pr > 0.5))[~band].sum())
    print(f"  card vs CPU port, 2 images: probabilities max |d| {err:.3g} "
          f"(bound {UNET_PROB_ATOL:g}); mask pixels that differ off the "
          f"{UNET_BAND:g} band {off}, pixels in the band {int(band.sum())}; "
          f"foreground share {float((pr > 0.5).float().mean()):.3f}")
    if err > UNET_PROB_ATOL or off:
        fail("UNet++: card and CPU port differ beyond the bound")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for i, p in enumerate(prints):
            (root / "in").mkdir(exist_ok=True)
            (root / "in" / f"{i + 1}_1_1.jpg").write_bytes(
                encode_jpeg(np.round(p * 255.0).astype(np.uint8)))
        v = unet_variables_from_state(cpu_model.state_dict())
        ckpt = save_msgpack(root / "best.msgpack", {
            "params": v["params"], "batch_stats": v["batch_stats"],
            "opt_state": None, "epoch": 0})
        n, t_seg = wall_s(lambda: segmentation_infer.segment_images(
            root / "in", root / "out", ckpt))
        outs = sorted(p.name for p in (root / "out").iterdir())
        mask = read_image_grayscale(root / "out" / "1_1_1_mask.png")
        print(f"  segment_images (configs/config_segmentation.yml, on the "
              f"card): {n} images in {t_seg:.2f} s, {len(outs)} files; "
              f"first mask {mask.shape}, foreground {int((mask > 0).sum())}")
        if n != 4 or len(outs) != 12 or mask.shape != (320, 240) or not (
                0 < int((mask > 0).sum()) < mask.size):
            fail("segment_images outputs")
    return dict(rates=rates, prob_err=err, segment_s=t_seg)


def coassignment(a: dict, b: dict) -> float:
    """Share of file pairs that two labellings put together or apart
    alike."""
    import numpy as np
    keys = sorted(a)
    la = np.asarray([a[k] for k in keys])
    lb = np.asarray([b[k] for k in keys])
    same_a = la[:, None] == la[None, :]
    same_b = lb[:, None] == lb[None, :]
    iu = np.triu_indices(len(keys), 1)
    return float((same_a == same_b)[iu].mean())


def read_csv_labels(path) -> dict:
    import csv
    with open(path, newline="") as f:
        return {r["path"]: int(r["cluster_label"]) for r in csv.DictReader(f)}


def ssl_run_all_phase(dev, build, card) -> dict:
    """``pipeline.run_all(skip_ssl=False, train=False, demo_matching=False)``
    on the card from a raw tree: 16 subjects x 10 PolyU-named JPEGs under
    ``DBII/`` and 4 x 2 NIST-named PNGs under ``Nist/``
    (``tools/polyu_set.write_raw``), the shipped classifier config with its
    paths in a temporary directory, and a checkpoint the phase writes.
    Checks ``id_clusters.csv``, the id check, ``sorted_report.json``,
    ``sorted_dataset/cluster_*`` holding every file once, the file stages'
    counts and outputs, launches of every kernel, the EER bounds; then the
    SSL step on the CPU port from the same files: co-assignment of the two
    ``id_clusters.csv`` >= COASSIGN_MIN. Prints each stage's seconds."""
    import os
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch import pipeline
    from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (
        pipeline as ssl_pipeline)
    polyu_set, front = load_tool("polyu_set"), load_tool("ssl_front_port")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "dataset"
        t0 = time.perf_counter()
        files = polyu_set.write_raw(data, RAW_SUBJECTS, RAW_NIST)
        cfg = front.classifier_config(root)
        ckpt = front.write_checkpoint(cfg, seed=42)
        t_setup = time.perf_counter() - t0
        for k in build.LAUNCHES:
            build.LAUNCHES[k] = 0
        os.chdir(root)
        try:
            res, t_all = wall_s(lambda: pipeline.run_all(
                str(data), classifier_config=str(cfg), train=False,
                demo_matching=False))
        finally:
            os.chdir(cwd)
        launches = dict(build.LAUNCHES)
        ssl, mat = res["ssl"], res["matching"]
        save = root / "save_models"
        card_labels = read_csv_labels(save / "id_clusters.csv")
        n = len(files)
        sorted_names = sorted(p.name for p in (data / "sorted_dataset").rglob("*")
                              if p.is_file())
        print(f"  {n} raw files written in {t_setup:.2f} s (with the "
              f"checkpoint); run_all {t_all:.2f} s: {ssl['num_images']} "
              f"embedded, {ssl['num_ids']} ids, clusters "
              f"{ssl['clustering_report']['cluster_sizes']}, catalog rows "
              f"{res['catalog_rows']}, minutiae {res['features']['num_images']}, "
              f"{mat['num_users']} users")
        checks = {
            "id_clusters.csv rows": len(card_labels) == n,
            "id consistency": res["id_consistency"]["ok"],
            "sorted_report.json": (save / "sorted_report.json").is_file(),
            "sorted_dataset holds every file once":
                sorted_names == sorted(Path(r).name for r in files),
            "stage counts": (res["catalog_rows"] == ssl["num_images"] == n
                             == res["preprocessing"]["num_images"]
                             == res["features"]["num_images"]),
            "skeletons": len(list((data / "processed" / "enhanced").rglob(
                "*_skeleton.jpg"))) == n,
            "minutiae JSON": len(list((data / "processed" / "minutiae").rglob(
                "*_minutiae.json"))) == n,
            "logs": all((root / "logs" / f).is_file() for f in (
                "minutiae_stats.csv", "genuine_match_stats.csv", "roc.png")),
            "every kernel launched": all(v > 0 for v in launches.values()),
            "embeddings_clusters.png": _figure_ok(
                root / "results" / "img" / "embeddings_clusters.png"),
        }
        print("  checks: " + ", ".join(f"{k} {'ok' if v else 'FAILED'}"
                                       for k, v in checks.items()))
        print(f"  launches over run_all: {launches}")
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"run_all from a raw tree: {bad}")
        figure = figure_timings(dev, ssl["embeddings"], card)
        g, imp = mat["genuine_scores"], mat["impostor_scores"]
        gap = float(g.mean() - imp.mean())
        print(f"  EER {mat['eer']:.4f} (<= 0.13), genuine mean {g.mean():.4f}, "
              f"impostor mean {imp.mean():.4f}, gap {gap:.4f} (>= 0.3)")
        if mat["eer"] > 0.13 or gap < 0.3:
            fail("run_all from a raw tree: EER or gap outside the bounds")

        cpu_root = root / "cpu"
        cpu_root.mkdir()
        cpu_cfg = front.classifier_config(cpu_root)
        (cpu_root / "save_models").mkdir()
        (cpu_root / "save_models" / ckpt.name).write_bytes(ckpt.read_bytes())
        os.chdir(cpu_root)
        try:
            cpu_res, t_cpu = wall_s(lambda: ssl_pipeline.main(
                str(cpu_cfg), ssl_pipeline.discover_dataset_dirs(data),
                train=False, device="cpu"))
        finally:
            os.chdir(cwd)
        cpu_labels = read_csv_labels(cpu_root / "save_models" / "id_clusters.csv")
        agree = coassignment(card_labels, cpu_labels)
        emb_err = float(np.abs(ssl["embeddings"] - cpu_res["embeddings"]).max())
        print(f"  SSL step on the CPU port ({t_cpu:.2f} s): embeddings max |d| "
              f"{emb_err:.3g}; id_clusters.csv co-assignment {agree:.4f} "
              f"(>= {COASSIGN_MIN}); labels equal "
              f"{card_labels == cpu_labels}")
        if set(cpu_labels) != set(card_labels) or agree < COASSIGN_MIN:
            fail("run_all from a raw tree: card and CPU clusterings disagree")
    seconds = {**{f"ssl {k}": v for k, v in ssl["seconds"].items()},
               **{k: v for k, v in res["seconds"].items() if k != "ssl"}}
    print(f"  stage seconds on {card}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in seconds.items()))
    return dict(run_all_s=t_all, seconds=seconds, launches=launches,
                coassignment=agree, emb_err=emb_err, eer=mat["eer"],
                figure=figure)


FIGURE_POINTS = (3000, 256)   # the JAX module's max_points, a 256-wide embedding
TSNE_KL_RTOL = 0.05           # card vs CPU t-SNE: final KL divergence
TSNE_TRUST_ATOL = 0.02        # and trustworthiness (k=5)


def _figure_ok(path: Path) -> bool:
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        read_rgb)
    return path.is_file() and read_rgb(path).shape == (720, 840, 3)


def trustworthiness(x, y, k: int = 5) -> float:
    """scikit-learn's ``trustworthiness`` in numpy (not on the card's
    machine): how far the embedding's k nearest neighbours rank in the
    input's neighbour order."""
    import numpy as np
    n = x.shape[0]
    dx = ((x[:, None] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(dx, np.inf)
    order = np.argsort(dx, axis=1, kind="stable")
    ranks = np.empty_like(order)
    ranks[np.arange(n)[:, None], order] = np.arange(1, n + 1)[None]
    dy = ((y[:, None] - y[None]) ** 2).sum(-1)
    np.fill_diagonal(dy, np.inf)
    nn_y = np.argsort(dy, axis=1, kind="stable")[:, :k]
    r = ranks[np.arange(n)[:, None], nn_y] - k
    return float(1.0 - 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))
                 * np.maximum(r, 0).sum())


def figure_timings(dev, embeddings, card) -> dict:
    """The embedding figure's 2-D reduction (``classifier.visualize``):
    t-SNE on the card at the phase's file count and at 3,000 256-wide
    synthetic embeddings, each timed; the first held against the same call
    on a CPU copy (t-SNE is chaotic: final KL within TSNE_KL_RTOL,
    trustworthiness within TSNE_TRUST_ATOL, the bounds of
    ``tests/test_torch_visualize.py``)."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (
        visualize as V)

    x = np.asarray(embeddings, np.float32)
    (card_pts, _), t_card = wall_s(lambda: V.embed_2d(x, "tsne", device=dev))
    t0 = time.perf_counter()
    cpu_pts, _ = V.embed_2d(x, "tsne", device="cpu")
    t_cpu = time.perf_counter() - t0
    xin = V.pca(torch.from_numpy(x), 50).numpy() if x.shape[1] > 50 else x
    p = V.joint_probabilities(torch.from_numpy(xin),
                              max(2, min(30, (x.shape[0] - 1) // 3)))
    kl_card, kl_cpu = V.kl_divergence(card_pts, p), V.kl_divergence(cpu_pts, p)
    tw_card = trustworthiness(xin, card_pts)
    tw_cpu = trustworthiness(xin, cpu_pts)
    rng = np.random.default_rng(0)
    n, d = FIGURE_POINTS
    centers = rng.normal(0, 1.5, (8, d))
    big = (centers[rng.integers(0, 8, n)] + rng.normal(0, 1, (n, d))).astype(
        np.float32)
    (big_pts, _), t_big = wall_s(lambda: V.embed_2d(big, "tsne", device=dev))
    print(f"  embedding figure's t-SNE: {x.shape[0]} files {t_card:.2f} s on "
          f"the card ({t_cpu:.2f} s on the CPU port); {n} x {d} synthetic "
          f"{t_big:.2f} s on the card ({card}); card vs CPU: KL "
          f"{kl_card:.4f} vs {kl_cpu:.4f}, trustworthiness {tw_card:.4f} vs "
          f"{tw_cpu:.4f}")
    if (not np.isfinite(big_pts).all() or not np.isfinite(card_pts).all()
            or abs(kl_card - kl_cpu) > TSNE_KL_RTOL * kl_cpu
            or abs(tw_card - tw_cpu) > TSNE_TRUST_ATOL):
        fail("embedding figure: the card's t-SNE against the CPU's")
    return dict(files=int(x.shape[0]), tsne_s=t_card, tsne_cpu_s=t_cpu,
                tsne_3000_s=t_big, kl=(kl_card, kl_cpu),
                trustworthiness=(tw_card, tw_cpu))


# --- training: SSL (host and device views), UNet++, run_all(train=True) -------

TRAIN_STEPS = 8               # timed SSL steps a path, after one warm-up step
TRAIN_SET = (1480, 320, 240)  # the device-resident uint8 set (tools/polyu_set.py)
TRAIN_FILES = 16              # subjects x 10 JPEGs the host views read
TRAIN_CMP_STEPS = 2           # SSL steps on the card and on the CPU port
TRAIN_LOSS_ATOL = 1e-4        # card vs CPU port after two steps
TRAIN_STATS_ATOL = 1e-4
TRAIN_MOMENT_RTOL = 1e-3      # ||card - CPU|| / ||CPU|| of Adam's mu and nu
TRAIN_MOVE_RTOL = 1e-2        # the same of the parameters' moves
TRAIN_VIEW_ATOL = 1e-6        # device_views, card vs CPU (erfinv's last place)
SEG_SUBJECTS = 4              # x 10 image/mask pairs (masks by the runner)
SEG_EPOCHS = 2


def _ssl_cfg(root: Path, **training):
    """The shipped classifier config with its paths under ``root`` and
    ``ssl.training`` keys replaced."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.config import (
        load_classifier_config)
    path = load_tool("ssl_front_port").classifier_config(root)
    text = path.read_text()
    for key, value in training.items():
        old = next(line for line in text.splitlines()
                   if line.strip().startswith(f"{key}:"))
        text = text.replace(old + "\n", f"    {key}: {value}\n")
    path.write_text(text)
    return path, load_classifier_config(path)


def _param_snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


def ssl_train_phase(dev, card) -> dict:
    """(a) The SSL model at full width on ``configs/config_classifier.yml``
    (lr 1e-5, warmup as configured): ``train_ssl`` for 8 steps on
    ``two_view_batches`` over PolyU-shaped JPEGs (a wrapper of the batch
    iterator times each step and the host's view rendering, and sees the
    weights between steps: step 0 moves none, step 1 some), then
    ``train_ssl_device``'s step on a device-resident uint8 set of 1,480
    images of 320x240 (one warm-up step, 8 timed, synchronized), and the
    trainer itself for one epoch of that set; peak device memory;
    ``device_views`` on the card against the same call on the CPU (the
    noise's bits equal, the views within an ulp-level bound); two steps on
    the card against the CPU port from the same weights and views (loss,
    running statistics, Adam's moments and the parameters' moves); the
    card's final checkpoint read back tensor by tensor."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (
        data as cdata)
    from multimodal_biometric_fingerprints_palms_tpu_torch.classifier.pipeline import (
        build_model)
    from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
        load_jax_variables, seed_weights, ssl_variables_from_state)
    from multimodal_biometric_fingerprints_palms_tpu_torch.train import (
        ssl_train)
    from multimodal_biometric_fingerprints_palms_tpu_torch.train.optim import (
        ClipAdamW)
    from multimodal_biometric_fingerprints_palms_tpu_torch.train.schedule import (
        cosine_warmup_schedule)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
        load_msgpack)
    polyu_set = load_tool("polyu_set")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _, cfg = _ssl_cfg(root)
        t, dcfg = cfg.ssl.training, cfg.ssl.dataset
        tcfg = {k: t.get(k) for k in ("lr", "epochs", "warmup_epochs",
                                      "weight_decay", "grad_clip",
                                      "temperature")}
        lr, batch = float(tcfg["lr"]), int(dcfg.get("batch_size"))
        size, seed = int(dcfg.get("image_size")), int(dcfg.get("seed"))
        files = sorted(polyu_set.write_raw(root / "dataset", TRAIN_FILES))
        paths = cdata.collect_image_paths([root / "dataset" / "DBII"])
        spe = len(paths) // batch
        print(f"  config: lr {lr:g}, batch {batch}, {size}x{size}, warmup "
              f"{tcfg["warmup_epochs"]} epochs, {tcfg["epochs"]} epochs; "
              f"{len(files)} JPEGs")

        # host views through the real trainer, 8 steps
        model = build_model(cfg)
        marks, seen = [], {}

        def batches():
            it = cdata.two_view_batches(paths, batch, size, seed=seed + 1)
            for k in range(TRAIN_STEPS + 1):
                if k <= 2:
                    seen[k - 1] = _param_snapshot(model)
                t0 = time.perf_counter()
                pair = next(it)
                marks.append((t0, time.perf_counter()))
                yield pair
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), None))

        torch.cuda.reset_peak_memory_stats()
        state, hist = ssl_train.train_ssl(
            model, batches, spe, epochs=1, lr=lr,
            weight_decay=tcfg["weight_decay"], grad_clip=tcfg["grad_clip"],
            warmup_epochs=tcfg["warmup_epochs"], temperature=tcfg["temperature"],
            input_shape=(size, size), seed=seed, save_dir=root / "save",
            device=dev)
        host_peak = torch.cuda.max_memory_allocated()
        views_ms = [1e3 * (b - a) for a, b in marks[:-1]]
        steps_ms = [1e3 * (marks[k + 1][0] - marks[k][1])
                    for k in range(len(marks) - 1)]
        moved0 = sum(int((a != b).sum()) for a, b in zip(seen[-1], seen[0]))
        moved1 = sum(int((a != b).sum()) for a, b in zip(seen[0], seen[1]))
        n_par = sum(p.numel() for p in model.parameters())
        host_step = float(np.mean(steps_ms[1:]))
        host_views = float(np.mean(views_ms[1:]))
        print(f"  train_ssl (host views), {TRAIN_STEPS + 1} steps: loss "
              f"{hist[0]:.4f}; step {host_step:.2f} ms after one warm-up "
              f"(device, synchronized by the loss read), host views "
              f"{host_views:.2f} ms a step -> "
              f"{2 * batch * 1e3 / (host_step + host_views):.1f} views/s end "
              f"to end; peak {host_peak / 2 ** 20:.1f} MiB ({card})")
        print(f"  weights moved by step 0 (lr 0): {moved0} of {n_par}; by "
              f"step 1: {moved1}")
        final = load_msgpack(root / "save" / "ssl_model_final.msgpack")
        back = load_jax_variables(build_model(cfg), {
            "params": final["params"], "batch_stats": final["batch_stats"]})
        ref = {k: t.cpu() for k, t in model.state_dict().items()}
        differ = [k for k, t in back.state_dict().items()
                  if not k.endswith("num_batches_tracked")
                  and not torch.equal(t, ref[k])]
        print(f"  checkpoint written on the card: step {final['step']}, "
              f"tensors that differ read back {len(differ)}")
        if (not all(np.isfinite(hist)) or moved0 or not moved1 or differ
                or final["step"] != TRAIN_STEPS + 1):
            fail("SSL training on host views: loss, step-0/1 weights or "
                 "checkpoint")
        out["host"] = dict(step_ms=host_step, views_ms=host_views,
                           views_s=2 * batch * 1e3 / (host_step + host_views),
                           peak_bytes=host_peak, loss=hist[0],
                           moved_step0=moved0, moved_step1=moved1)

        # device views: the trainer's step timed, then its epoch
        n, h, w = TRAIN_SET
        subjects = n // 10
        from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
            blob_prints)
        data = np.concatenate([np.round(blob_prints(
            [10 + s] * 10, [0.06 * k for k in range(10)], h, w) * 255.0
        ).astype(np.uint8) for s in range(1, subjects + 1)])
        model = build_model(cfg).to(dev)
        tx = ClipAdamW(tcfg["grad_clip"], cosine_warmup_schedule(
            lr, tcfg["warmup_epochs"] * (n // batch), tcfg["epochs"] * (n // batch)),
            tcfg["weight_decay"])
        rng = threefry.key(seed)
        st = ssl_train.init_ssl_state(model, rng, (size, size), tx)
        step = ssl_train.create_ssl_train_step(model, tx, tcfg["temperature"])
        torch.cuda.reset_peak_memory_stats()
        data_dev, t_up = wall_s(lambda: torch.from_numpy(data).to(dev))
        order = np.random.default_rng(seed).permutation(n)
        views_t, step_t, losses = [], [], []
        for b in range(TRAIN_STEPS + 1):
            idx = torch.from_numpy(order[b * batch:(b + 1) * batch]).to(dev)
            rng, sub = threefry.split(rng)
            (xi, xj), tv = wall_s(lambda: ssl_train.device_views(
                data_dev, idx, sub, size))
            (st, loss), ts = wall_s(lambda: step(st, xi, xj,
                                                 threefry.fold_in(sub, 2)))
            views_t.append(tv)
            step_t.append(ts)
            losses.append(float(loss))
        dev_peak = torch.cuda.max_memory_allocated()
        dev_step = 1e3 * float(np.mean(step_t[1:]))
        dev_views = 1e3 * float(np.mean(views_t[1:]))
        print(f"  device views: {n} x {h}x{w} uint8 ({data.nbytes / 1e6:.1f} "
              f"MB) to the card in {t_up * 1e3:.1f} ms; step {dev_step:.2f} ms, "
              f"views {dev_views:.2f} ms on the card a step -> "
              f"{2 * batch * 1e3 / (dev_step + dev_views):.1f} views/s; peak "
              f"{dev_peak / 2 ** 20:.1f} MiB; losses {losses[0]:.4f} .. "
              f"{losses[-1]:.4f}")
        del data_dev
        model = build_model(cfg)
        (_, dhist), t_epoch = wall_s(lambda: ssl_train.train_ssl_device(
            model, data, batch, epochs=1, lr=lr,
            weight_decay=tcfg["weight_decay"], grad_clip=tcfg["grad_clip"],
            warmup_epochs=tcfg["warmup_epochs"], temperature=tcfg["temperature"],
            image_size=size, seed=seed, save_dir=root / "save_dev",
            device=dev))
        print(f"  train_ssl_device, one epoch ({n // batch} steps): "
              f"{t_epoch:.2f} s, {t_epoch * 1e3 / (n // batch):.2f} ms a step, "
              f"loss {dhist[0]:.4f}")
        if not (all(np.isfinite(losses)) and np.isfinite(dhist[0])):
            fail("SSL training on device views: loss not finite")
        out["device"] = dict(step_ms=dev_step, views_ms=dev_views,
                             views_s=2 * batch * 1e3 / (dev_step + dev_views),
                             peak_bytes=dev_peak, upload_s=t_up,
                             epoch_s=t_epoch, epoch_steps=n // batch,
                             loss=dhist[0])

        # device_views on the card against the same call on a CPU copy
        from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (
            augment_device)
        idx = order[:batch]
        sub = threefry.split(threefry.key(seed))[1]
        on_card = ssl_train.device_views(torch.from_numpy(data).to(dev),
                                         torch.from_numpy(idx).to(dev), sub,
                                         size)
        on_cpu = ssl_train.device_views(torch.from_numpy(data),
                                        torch.from_numpy(idx), sub, size)
        view_d = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(on_card, on_cpu))
        bits_equal = all(torch.equal(
            threefry.random_bits_tensor(keys, size * size, dev).cpu(),
            threefry.random_bits_tensor(keys, size * size, "cpu"))
            for keys in (augment_device.draws(threefry.fold_in(sub, v), batch,
                                              h, w, size)["noise_keys"]
                         for v in (0, 1)))
        print(f"  device_views, card vs CPU, {batch} images: noise bits equal "
              f"{bits_equal}; views max |d| {view_d:.3g} (bound "
              f"{TRAIN_VIEW_ATOL:g})")
        if not (bits_equal and view_d <= TRAIN_VIEW_ATOL):
            fail("device_views: the card and the CPU port differ")

        # card vs CPU port: two steps from the same weights and views
        g = np.random.default_rng(3)
        cpu_model = seed_weights(build_model(cfg), seed)
        card_model = build_model(cfg)
        card_model.load_state_dict(cpu_model.state_dict())
        card_model.to(dev)
        start = _param_snapshot(cpu_model)
        tx_c, tx_g = (ClipAdamW(tcfg["grad_clip"], cosine_warmup_schedule(
            lr, 1, 8), tcfg["weight_decay"]) for _ in range(2))
        sc = ssl_train.SSLTrainState({}, {}, tx_c.init(list(cpu_model.parameters())), 0)
        sg = ssl_train.SSLTrainState({}, {}, tx_g.init(list(card_model.parameters())), 0)
        step_c = ssl_train.create_ssl_train_step(cpu_model, tx_c)
        step_g = ssl_train.create_ssl_train_step(card_model, tx_g)
        rng = threefry.key(5)
        loss_d = 0.0
        for _ in range(TRAIN_CMP_STEPS):
            xi, xj = (torch.from_numpy(g.random((batch, size, size), np.float32))
                      for _ in range(2))
            rng, sub = threefry.split(rng)
            sc, lc = step_c(sc, xi, xj, sub)
            sg, lg = step_g(sg, xi.to(dev), xj.to(dev), sub)
            loss_d = max(loss_d, abs(float(lc) - float(lg)))
        vc = ssl_variables_from_state(cpu_model.state_dict())
        vg = ssl_variables_from_state(card_model.state_dict())

        def tree_max(a, b):
            if isinstance(a, dict):
                return max(tree_max(a[k], b[k]) for k in a)
            return float(np.abs(a - b).max())

        def rel_norm(want, got):
            """||got - want|| / ||want|| over lists of CPU tensors."""
            num = sum(float(((b.double() - a.double()) ** 2).sum())
                      for a, b in zip(want, got))
            den = sum(float((a.double() ** 2).sum()) for a in want)
            return (num / den) ** 0.5

        cpu_ = lambda ts: [t.detach().cpu() for t in ts]
        mu_d = rel_norm(cpu_(sc.opt_state.mu), cpu_(sg.opt_state.mu))
        nu_d = rel_norm(cpu_(sc.opt_state.nu), cpu_(sg.opt_state.nu))
        move_d = rel_norm(
            [a - s for a, s in zip(cpu_(cpu_model.parameters()), start)],
            [b - s for b, s in zip(cpu_(card_model.parameters()), start)])
        par_d = tree_max(vc["params"], vg["params"])
        stat_d = tree_max(vc["batch_stats"], vg["batch_stats"])
        par_bound = 2 * lr + 1e-6
        print(f"  card vs CPU port, {TRAIN_CMP_STEPS} steps from the same "
              f"weights and views: loss max |d| {loss_d:.3g} (bound "
              f"{TRAIN_LOSS_ATOL:g}), running statistics {stat_d:.3g} "
              f"({TRAIN_STATS_ATOL:g}); Adam's moments, relative norm of the "
              f"difference: mu {mu_d:.3g}, nu {nu_d:.3g} "
              f"({TRAIN_MOMENT_RTOL:g}); the parameters' moves {move_d:.3g} "
              f"({TRAIN_MOVE_RTOL:g}); parameters max |d| {par_d:.3g} "
              f"({par_bound:g})")
        if not (loss_d <= TRAIN_LOSS_ATOL and stat_d <= TRAIN_STATS_ATOL
                and mu_d <= TRAIN_MOMENT_RTOL and nu_d <= TRAIN_MOMENT_RTOL
                and move_d <= TRAIN_MOVE_RTOL and par_d <= par_bound):
            fail("SSL training: card and CPU port differ beyond the bounds")
        out["parity"] = dict(loss=loss_d, stats=stat_d, params=par_d,
                             mu=mu_d, nu=nu_d, moves=move_d, views=view_d)
    return out


def seg_train_phase(dev, card) -> dict:
    """(b) UNet++ at the config's filters (64 .. 1024), 256x256, batch 4:
    masks written by the port's preprocessing runner with ``debug``
    (``<out>/debug/<cluster>/mask/<name>``) for 40 PolyU-shaped prints,
    ``train_from_config`` for 2 epochs on the card (ms a step, peak
    memory, val dice and IoU), then a resume from ``last.msgpack``: it
    starts at the saved epoch + 1 with the lr, ``count``, ``mu`` and
    ``nu`` saved."""
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.runner import (
        run_preprocessing)
    from multimodal_biometric_fingerprints_palms_tpu_torch.train import (
        seg_train)
    from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
        NestedUNet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
        load_msgpack)
    polyu_set = load_tool("polyu_set")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        files = polyu_set.write_raw(root / "raw", SEG_SUBJECTS)
        images = root / "images" / "cluster_0"
        images.mkdir(parents=True)
        for f in sorted((root / "raw" / "DBII").iterdir()):
            (images / f.name).write_bytes(f.read_bytes())
        _, t_masks = wall_s(lambda: run_preprocessing(
            root / "images", root / "processed", debug=True, device=dev))
        ckpt = root / "seg"
        text = (ROOT / "configs" / "config_segmentation.yml").read_text()
        for old, new in (
                ("images_dir: dataset/DBII", f"images_dir: {root / 'images'}"),
                ("masks_dir: dataset/processed/debug",
                 f"masks_dir: {root / 'processed' / 'debug'}"),
                ("epochs: 10", f"epochs: {SEG_EPOCHS}"),
                ("checkpoint_dir: save_models/segmentation",
                 f"checkpoint_dir: {ckpt}"),
                ("curves_csv: logs/seg_training_curve.csv",
                 f"curves_csv: {ckpt / 'curve.csv'}")):
            if old not in text:
                fail(f"configs/config_segmentation.yml has no '{old}'")
            text = text.replace(old, new)
        cfg = root / "seg.yml"
        cfg.write_text(text)
        torch.cuda.reset_peak_memory_stats()
        res, t_train = wall_s(lambda: seg_train.train_from_config(
            str(cfg), device=dev))
        peak = torch.cuda.max_memory_allocated()
        secs, steps = res["seconds"], res["steps"]
        ms_step = 1e3 * secs["train_steps"] / steps
        last = res["history"][-1]
        n_pairs = len(seg_train.collect_image_mask_paths(
            root / "images", root / "processed" / "debug"))
        print(f"  masks by run_preprocessing(debug=True): {n_pairs} pairs of "
              f"{len(files)} files in {t_masks:.2f} s; train_from_config "
              f"{SEG_EPOCHS} epochs, {steps} steps in {t_train:.2f} s: "
              f"{ms_step:.2f} ms a step (synchronized by the loss read), host "
              f"batches {1e3 * secs['batches'] / max(steps, 1):.2f} ms a step, "
              f"eval {secs['eval']:.2f} s; peak {peak / 2 ** 20:.1f} MiB; val "
              f"dice {last['val_dice']:.4f}, IoU {last['val_iou']:.4f}, loss "
              f"{last['loss']:.4f} ({card})")
        saved = load_msgpack(ckpt / "last.msgpack")
        scfg = seg_train.load_segmentation_config(str(cfg))
        model = NestedUNet(tuple(scfg.get("model.filters")))
        tx = seg_train.make_tx(scfg, n_pairs - max(1, int(n_pairs * 0.2)), 4)
        opt, start = seg_train.resume_state(model, tx, ckpt / "last.msgpack",
                                            dev)
        adam = saved["opt_state"]["1"]
        tree = tx.to_flax(opt, lambda ts: seg_train.params_tree_of(model, ts))

        def same(a, b):
            if isinstance(a, dict):
                return all(same(a[k], b[k]) for k in a)
            return bool(np.array_equal(np.asarray(a), np.asarray(b)))

        checks = {
            "epoch + 1": start == saved["epoch"] + 1 == SEG_EPOCHS,
            "lr": opt.hyperparams["learning_rate"] == np.float32(
                adam["hyperparams"]["learning_rate"]),
            "count": opt.count == int(adam["inner_state"]["0"]["count"])
                     == steps,
            "mu": same(adam["inner_state"]["0"]["mu"],
                       tree["1"]["inner_state"]["0"]["mu"]),
            "nu": same(adam["inner_state"]["0"]["nu"],
                       tree["1"]["inner_state"]["0"]["nu"]),
            "finite losses": all(np.isfinite(h["loss"]) for h in res["history"]),
        }
        text = text.replace("resume_from_checkpoint: null",
                            f"resume_from_checkpoint: {ckpt / 'last.msgpack'}")
        text = text.replace(f"epochs: {SEG_EPOCHS}", f"epochs: {SEG_EPOCHS + 1}")
        text = text.replace(f"checkpoint_dir: {ckpt}",
                            f"checkpoint_dir: {root / 'seg2'}")
        cfg.write_text(text)
        res2 = seg_train.train_from_config(str(cfg), device=dev)
        checks["resumed run starts at the next epoch"] = (
            [h["epoch"] for h in res2["history"]] == [SEG_EPOCHS])
        print("  resume from last.msgpack: " + ", ".join(
            f"{k} {'ok' if v else 'FAILED'}" for k, v in checks.items()))
        if not all(checks.values()):
            fail("UNet++ training or its resume")
    return dict(ms_step=ms_step, steps=steps, peak_bytes=peak,
                val_dice=last["val_dice"], val_iou=last["val_iou"],
                seconds=secs, train_s=t_train)


def train_run_all_phase(dev, build, card) -> dict:
    """(c) ``run_all(skip_ssl=False, train=True)`` from the raw tree of
    ``ssl_run_all_phase`` (168 files), 1 epoch, no checkpoint: it trains,
    writes ``ssl_model_final.msgpack``, clusters, sorts and runs the file
    stages to EER; held to that phase's bounds."""
    import os
    from multimodal_biometric_fingerprints_palms_tpu_torch import pipeline
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
        load_msgpack)
    polyu_set = load_tool("polyu_set")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data = root / "dataset"
        files = polyu_set.write_raw(data, RAW_SUBJECTS, RAW_NIST)
        cfg, ccfg = _ssl_cfg(root, epochs=1)
        batch = int(ccfg.ssl.dataset.get("batch_size"))
        for k in build.LAUNCHES:
            build.LAUNCHES[k] = 0
        os.chdir(root)
        try:
            res, t_all = wall_s(lambda: pipeline.run_all(
                str(data), classifier_config=str(cfg), train=True,
                demo_matching=False))
        finally:
            os.chdir(cwd)
        launches = dict(build.LAUNCHES)
        final = root / "save_models" / "ssl_model_final.msgpack"
        payload = load_msgpack(final) if final.is_file() else {}
        ssl, mat = res["ssl"], res["matching"]
        sorted_n = len([p for p in (data / "sorted_dataset").rglob("*")
                        if p.is_file()])
        g, imp = mat["genuine_scores"], mat["impostor_scores"]
        gap = float(g.mean() - imp.mean())
        print(f"  {len(files)} raw files; run_all {t_all:.2f} s: trained "
              f"{ssl.get('training', {}).get('branch')} views, "
              f"{payload.get('step')} steps, loss "
              f"{ssl.get('training', {}).get('history')}; clusters "
              f"{ssl['clustering_report']['cluster_sizes']}; sorted "
              f"{sorted_n} files; EER {mat['eer']:.4f} (<= 0.13), gap "
              f"{gap:.4f} (>= 0.3)")
        seconds = {**{f"ssl {k}": v for k, v in ssl["seconds"].items()},
                   **{k: v for k, v in res["seconds"].items() if k != "ssl"}}
        print(f"  stage seconds on {card}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in seconds.items()))
        if (not payload or payload["step"] != len(files) // batch
                or "training" not in ssl or sorted_n != len(files)
                or mat["eer"] > 0.13 or gap < 0.3):
            fail("run_all(train=True) from a raw tree")
    return dict(run_all_s=t_all, seconds=seconds, eer=mat["eer"], gap=gap,
                launches=launches, steps=payload["step"])


def train_phase(dev, build, card) -> dict:
    """(a), (b) and (c) from a scratch working directory (the trainers and
    runners log to ``data/metadata/`` under it, as the JAX package's do)."""
    import os
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            print("  (a) SSL training, full width:")
            ssl = ssl_train_phase(dev, card)
            print("  (b) UNet++ training, filters 64 .. 1024:")
            seg = seg_train_phase(dev, card)
        finally:
            os.chdir(cwd)
    print("  (c) run_all(skip_ssl=False, train=True) from a raw tree:")
    raw = train_run_all_phase(dev, build, card)
    return dict(ssl=ssl, seg=seg, run_all=raw)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a GPU")
    if not (ROOT / PKG).is_dir() or not GOLDEN.is_file():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
        cuda_binarize, cuda_cc, cuda_kernels, cuda_morph, cuda_nlm, cuda_thin,
        denoise)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.components import (
        clean_mask)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.filters import (
        gaussian_blur)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.histogram import (
        clahe, otsu_threshold_patchwise, percentile_stretch)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.morphology import (
        binary_erode, binary_opening)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        preprocess_fingerprint, smooth_fingerprint_skeleton)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.enhance import (
        _quantize_u8)
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        extract_minutiae, postprocess_minutiae)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        blob_prints, make_batch)

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
    # the three CLAHE calls of the path: normalize, segment, binarize
    clahe_in = [(2.5, _quantize_u8(percentile_stretch(x, 0.5, 99.5))),
                (2.0, _quantize_u8(res.denoised)),
                (2.5, _quantize_u8(res.segmented))]
    clahe_err = 0.0
    print("kernel A (CLAHE):")
    variants = load_tool("binarize_clahe_variants")
    morph_tool = load_tool("morph_variants")
    with ThreadPoolExecutor(max_workers=3) as pool:     # one nvcc each
        jobs = (pool.submit(variants.build_parent, "mbfp_clahe"),
                pool.submit(variants.build_parent, "mbfp_binarize_front"),
                pool.submit(morph_tool.build_parent))
        (a_parent, a_regs), (f_parent, f_regs), (g_parent, g_regs) = (
            job.result() for job in jobs)
    print("  parent kernels built (tools/clahe_parent.cu, "
          "tools/binarize_parent.cu, tools/morph_parent.cu): ptxas: "
          + "; ".join(a_regs + f_regs + g_regs))
    for clip, inp in clahe_in:
        a, lut = cuda_kernels.clahe_cuda(inp, clip, 8, return_lut=True)
        b = cuda_kernels.clahe_plain(inp, clip, 8)
        lut_bad = int((lut != cuda_kernels.clahe_lut_plain(inp, clip, 8)).sum())
        old = int((a != variants.run_a(a_parent, True, inp, clip)[0]).sum())
        torch.cuda.synchronize()
        d = (a - b).abs()
        err = float(d.max())
        off = float((d > 1e-6).float().mean())
        print(f"  clip {clip}: max|d| {err:.3g}, pixels off {off:.3g}; LUT "
              f"entries that differ from clahe_lut_plain {lut_bad} / "
              f"{lut.numel()}; pixels that differ from the parent kernel {old}")
        if not torch.isfinite(a).all() or err > CLAHE_ATOL or off > CLAHE_MAX_OFF:
            fail(f"CLAHE clip {clip} outside tolerance")
        if lut_bad or old:
            fail(f"CLAHE clip {clip}: LUTs differ from the twin's or the "
                 "image from the parent kernel's")
        clahe_err = max(clahe_err, err)
    inp = clahe_in[0][1]
    clahe_parent_ms = time_ms(
        lambda: variants.run_a(a_parent, True, inp, 2.5), 20)
    clahe_ms = time_ms(lambda: cuda_kernels.clahe_cuda(inp, 2.5, 8), 20)
    clahe_plain_ms = time_ms(lambda: cuda_kernels.clahe_plain(inp, 2.5, 8), 5)
    npx = x.numel()
    # image in, image out; per pixel the bin, four LUT reads and the blend
    clahe_bound = bound(8.0 * npx, 15.0 * npx)
    print(f"  time per call: kernel {clahe_ms:.4f} ms, plain {clahe_plain_ms:.4f} ms, "
          f"parent kernel {clahe_parent_ms:.4f} ms, "
          f"bound {clahe_bound[0]:.4f} ms ({clahe_bound[1]})")
    clahe_ops = profile_ops(lambda: cuda_kernels.clahe_cuda(inp, 2.5, 8))
    print(f"  device ops of one wrapper call: {len(clahe_ops)} "
          f"({top_ops(clahe_ops, 3)})")

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
    # mask in, mask out; per label pass about 10 operations per pixel
    # (neighbour tests, the union, the tally, the keep test)
    cc_bound = bound(2.0 * npx, 20.0 * npx)
    print(f"  time per clean(64, 80) conn1 call: kernel {cc_ms:.4f} ms, "
          f"plain {cc_plain_ms:.4f} ms, bound {cc_bound[0]:.4f} ms "
          f"({cc_bound[1]})")

    print("kernel B, adversarial inputs:")
    kernel_b_adversarial(dev)

    print("kernel C (Zhang-Suen + prune):")
    gated = clean_mask(binary_smooth, 64, 80, connectivity=1) & (
        gaussian_blur(res.reliability, 2.0) > 0.1)
    for prune in (False, True):
        compare_exact(f"thin prune={prune}",
                      lambda: cuda_thin.zs_thin_cuda(gated, 128, prune),
                      lambda: cuda_thin.zs_thin_plain(gated, 128, prune))
    thin_ms = time_ms(lambda: cuda_thin.zs_thin_cuda(gated, 128, True), 20)
    thin_plain_ms = time_ms(lambda: cuda_thin.zs_thin_plain(gated, 128, True), 3)
    thin_bound = bound(2.0 * npx, thinning_work(gated))
    thin_dev = device_ms(profile_ops(
        lambda: cuda_thin.zs_thin_cuda(gated, 128, True)))
    print(f"  time per call: kernel {thin_ms:.4f} ms (device time of one call "
          f"{thin_dev:.4f} ms), plain {thin_plain_ms:.4f} ms, "
          f"bound {thin_bound[0]:.4f} ms ({thin_bound[1]})")
    print("kernel C, other frames and masks:")
    kernel_c_frames(dev, gated)
    print("kernel C, frames beyond one block (the device-memory form):")
    c_large = kernel_c_large_frames(dev, gated)

    print("kernel E (non-local means):")
    nlm_err = 0.0
    for prec, nb in (("bf16", BATCH), ("f32", 16)):
        inp = res.normalized[:nb]
        a = cuda_nlm.nlm_denoise_cuda(inp, precision=prec)
        b = denoise.nlm_denoise_plain(inp, precision=prec)
        torch.cuda.synchronize()
        d = (a - b).abs()
        err = float(d.max())
        off = int((d > 1e-6).sum())
        print(f"  {prec}, {nb} images: max|d| {err:.3g}, pixels off by > 1e-6 "
              f"{off} / {d.numel()}, pixels that differ {int((d > 0).sum())}")
        if not torch.isfinite(a).all() or err > NLM_ATOL \
                or off > NLM_MAX_OFF * d.numel():
            fail(f"NLM {prec} outside tolerance")
        nlm_err = max(nlm_err, err)
    nlm_ms = time_ms(lambda: cuda_nlm.nlm_denoise_cuda(res.normalized), 5)
    nlm_plain_ms = time_ms(lambda: denoise.nlm_denoise_plain(res.normalized), 2)
    # image in, image out; per pixel and offset: difference, square, 6 + 6
    # template adds, scale, exp, weighted sample, two accumulations
    nlm_bound = bound(8.0 * npx, 20.0 * 441 * npx)
    print(f"  time per call: kernel {nlm_ms:.4f} ms, plain {nlm_plain_ms:.4f} ms, "
          f"bound {nlm_bound[0]:.4f} ms ({nlm_bound[1]})")

    print("kernel E, small and ragged frames:")
    kernel_e_small_frames(dev)

    print("kernel F (Sauvola + patch Otsu):")
    img_eq = clahe(_quantize_u8(res.segmented), clip_limit=2.5, grid=8)
    fg = cuda_binarize.binarize_foreground_cuda(img_eq)
    fg_plain = cuda_binarize.binarize_foreground_plain(img_eq)
    fg_cpu = cuda_binarize.binarize_foreground_plain(img_eq[:4].cpu())
    torch.cuda.synchronize()
    f_bad = int((fg != fg_plain).sum())
    f_bad_cpu = int((fg[:4].cpu() != fg_cpu).sum())
    print(f"  hybrid: mismatches {f_bad} / {fg.numel()} against the twin on the "
          f"card, {f_bad_cpu} / {fg_cpu.numel()} against the twin on the CPU "
          f"(4 images); foreground {int(fg.sum())}")
    if f_bad > F_MAX_MISMATCH * fg.numel() \
            or f_bad_cpu > F_MAX_MISMATCH * fg_cpu.numel():
        fail("kernel F differs from its plain version beyond the bound")
    if not 0 < int(fg.sum()) < fg.numel():
        fail("kernel F comparison is trivial")
    # why the port divides a bin index by a tensor: on CUDA, PyTorch turns a
    # division by a Python scalar into a multiplication by its reciprocal
    thr = otsu_threshold_patchwise(img_eq, 32)
    bins = torch.round(thr * 255.0)
    flips = int(((img_eq < thr) != (img_eq < bins / 255.0)).sum())
    print(f"  pixels that `x < bin / 255` decides otherwise on this card when "
          f"the division is by a Python scalar: {flips} / {fg.numel()} "
          f"(thresholds that differ: {int((thr != bins / 255.0).sum())})")
    s_bad = int((cuda_binarize.sauvola_cuda(img_eq)
                 != cuda_binarize.sauvola_plain(img_eq)).sum())
    print(f"  Sauvola alone: mismatches {s_bad} / {fg.numel()}")
    if s_bad > F_MAX_MISMATCH * fg.numel():
        fail("kernel F (Sauvola alone) differs beyond the bound")
    for what, otsu, got in (("hybrid", True, fg),
                            ("Sauvola alone", False,
                             cuda_binarize.sauvola_cuda(img_eq))):
        old = int((got != variants.run_f(f_parent, True, img_eq, 25,
                                         otsu)).sum())
        print(f"  {what}: pixels that differ from the parent kernel {old}")
        if old:
            fail(f"kernel F ({what}) differs from the parent kernel")
    f_parent_ms = time_ms(
        lambda: variants.run_f(f_parent, True, img_eq, 25, True), 20)
    f_ms = time_ms(lambda: cuda_binarize.binarize_foreground_cuda(img_eq), 20)
    f_plain_ms = time_ms(
        lambda: cuda_binarize.binarize_foreground_plain(img_eq), 3)
    # float image in, byte mask out; per pixel two separable 25-tap box
    # means (x and x*x: 4 passes of 25 multiplies and 24 adds), the
    # threshold, and its share of the patch's histogram and Otsu scan
    f_bound = bound(5.0 * npx, 215.0 * npx)
    print(f"  time per call: kernel {f_ms:.4f} ms, plain {f_plain_ms:.4f} ms, "
          f"parent kernel {f_parent_ms:.4f} ms, "
          f"bound {f_bound[0]:.4f} ms ({f_bound[1]})")
    sv_parent_ms = time_ms(
        lambda: variants.run_f(f_parent, True, img_eq, 25, False), 20)
    sv_ms = time_ms(lambda: cuda_binarize.sauvola_cuda(img_eq), 20)
    sv_plain_ms = time_ms(lambda: cuda_binarize.sauvola_plain(img_eq), 3)
    sv_bound = bound(5.0 * npx, 212.0 * npx)      # F without the Otsu share
    print(f"  Sauvola alone, time per call: kernel {sv_ms:.4f} ms, plain "
          f"{sv_plain_ms:.4f} ms, parent kernel {sv_parent_ms:.4f} ms, bound "
          f"{sv_bound[0]:.4f} ms ({sv_bound[1]})")
    if sv_ms < sv_bound[0]:
        fail("kernel F (Sauvola alone) timed under its bound")
    f_ops = profile_ops(
        lambda: cuda_binarize.binarize_foreground_cuda(img_eq))
    print(f"  device ops of one wrapper call: {len(f_ops)} "
          f"({top_ops(f_ops, 4)})")
    # the file runner's staging size: one frame of 1024 x 1024
    big = torch.rand((1, 1024, 1024), generator=torch.Generator(
        device="cpu").manual_seed(9)).to(dev)
    compare_exact("binarize front 1024x1024",
                  lambda: cuda_binarize.binarize_foreground_cuda(big),
                  lambda: cuda_binarize.binarize_foreground_plain(big))
    compare_exact("sauvola 1024x1024",
                  lambda: cuda_binarize.sauvola_cuda(big),
                  lambda: cuda_binarize.sauvola_plain(big))
    for win in (5, 33):       # windows the kernel does not unroll for
        compare_exact(f"binarize front 1024x1024, win {win}",
                      lambda: cuda_binarize.binarize_foreground_cuda(big, win),
                      lambda: cuda_binarize.binarize_foreground_plain(big, win))
    print(f"  1024x1024, time per call: kernel "
          f"{time_ms(lambda: cuda_binarize.binarize_foreground_cuda(big), 20):.4f}"
          f" ms, plain "
          f"{time_ms(lambda: cuda_binarize.binarize_foreground_plain(big), 3):.4f}"
          " ms")

    print("kernel B alone, per mode (K6 is fill_holes on the object-filtered mask):")
    kept = cuda_cc.cc_filter_cuda(fg, "remove_small", 1, min_size=80)
    compare_exact("fill_holes(150) conn1 on the object-filtered mask",
                  lambda: cuda_binarize.fill_holes_phase2(kept),
                  lambda: cuda_cc.cc_filter_plain(kept, "fill_holes", 1,
                                                  max_size=150))
    cleaned = cuda_binarize.fill_holes_phase2(kept)
    one_pass = bound(2.0 * npx, 10.0 * npx)
    cc_modes = {}
    for mname, kern, plain in (
            ("remove_small(80) conn1",
             lambda: cuda_cc.cc_filter_cuda(fg, "remove_small", 1, min_size=80),
             lambda: cuda_cc.cc_filter_plain(fg, "remove_small", 1, min_size=80)),
            ("fill_holes(150) conn1",
             lambda: cuda_cc.cc_filter_cuda(kept, "fill_holes", 1, max_size=150),
             lambda: cuda_cc.cc_filter_plain(kept, "fill_holes", 1, max_size=150)),
            ("reach conn2",
             lambda: cuda_cc.cc_filter_cuda(opened, "reach", 2, marker=marker),
             lambda: cuda_cc.cc_filter_plain(opened, "reach", 2, marker=marker)),
            ("largest conn2",
             lambda: cuda_cc.cc_filter_cuda(binary_smooth, "largest", 2),
             lambda: cuda_cc.cc_filter_plain(binary_smooth, "largest", 2)),
            ("cc_label conn2",
             lambda: cuda_cc.cc_label_cuda(binary_smooth, 2),
             lambda: cuda_cc.cc_label_plain(binary_smooth, 2))):
        cc_modes[mname] = (time_ms(kern, 20), time_ms(plain, 3))
        # cc_label writes int32 labels instead of a byte mask
        b_ms, b_by = bound(5.0 * npx, 10.0 * npx) if "label" in mname else one_pass
        print(f"  {mname}: kernel {cc_modes[mname][0]:.4f} ms, plain "
              f"{cc_modes[mname][1]:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    print("  clean(64, 80) conn1, device ops of one call: " + top_ops(
        profile_ops(lambda: cuda_cc.cc_filter_cuda(
            binary_smooth, "clean", 1, min_size=64, max_size=80)), 6))

    print("kernel G (open -> erode -> reconstruct, a one-pass cross opening):")
    g_res = kernel_g_phase(dev, cleaned, res.binary, morph_tool, g_parent)
    compare_exact("unsplit entry point (F -> B clean -> G) against the split",
                  lambda: cuda_binarize.binarize_fused(img_eq),
                  lambda: cuda_binarize.binarize_fused_split(img_eq))
    print("  F -> B -> G per call: unsplit (B clean) "
          f"{time_ms(lambda: cuda_binarize.binarize_fused(img_eq), 10):.4f} ms, "
          "split (B remove_small, B fill_holes) "
          f"{time_ms(lambda: cuda_binarize.binarize_fused_split(img_eq), 10):.4f} ms")

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
        dense = (torch.rand((8, h, w), generator=g) < 0.8).to(dev)
        compare_exact(f"open/erode/reconstruct {h}x{w}",
                      lambda: cuda_morph.open_erode_reconstruct_cuda(dense),
                      lambda: cuda_morph.open_erode_reconstruct_plain(dense))
        img = torch.rand((4, h, w), generator=g).to(dev)
        for prec in ("bf16", "f32"):
            d = (cuda_nlm.nlm_denoise_cuda(img, precision=prec)
                 - denoise.nlm_denoise_plain(img, precision=prec)).abs()
            print(f"  nlm {prec} {h}x{w}: max|d| {float(d.max()):.3g}")
            if not float(d.max()) <= NLM_ATOL:
                fail("NLM outside tolerance at a small shape")
        compare_exact(f"sauvola {h}x{w}",
                      lambda: cuda_binarize.sauvola_cuda(img),
                      lambda: cuda_binarize.sauvola_plain(img))
        if h % 32 == 0 and w % 32 == 0:
            compare_exact(f"binarize front {h}x{w}",
                          lambda: cuda_binarize.binarize_foreground_cuda(img),
                          lambda: cuda_binarize.binarize_foreground_plain(img))
    # kernel A on small frames, odd tile sides (9 x 5, 5 x 3) and one pixel a
    # tile included, random and on the u8 grid: image and LUTs
    for h, w in ((32, 32), (48, 64), (64, 64), (40, 24), (72, 40), (8, 8)):
        for kind in ("random", "u8 grid"):
            img = torch.rand((4, h, w), generator=g)
            if kind == "u8 grid":
                img = torch.round(img * 255.0) / 255.0
            img = img.to(dev)
            a, lut = cuda_kernels.clahe_cuda(img, 2.0, 8, return_lut=True)
            d = (a - cuda_kernels.clahe_plain(img, 2.0, 8)).abs()
            lut_bad = int((lut != cuda_kernels.clahe_lut_plain(img, 2.0, 8)).sum())
            print(f"  clahe {h}x{w} {kind} (tiles {h // 8}x{w // 8}): max|d| "
                  f"{float(d.max()):.3g}, LUT entries that differ {lut_bad}")
            if float(d.max()) > CLAHE_ATOL or lut_bad:
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
    expected = {"clahe": 3, "cc": 4, "thin": 1, "match": 0, "nlm": 1,
                "binarize": 1, "morph": 1}
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

    # device busy share of one run: host clock against the summed device
    # time of the operations the same run issues under torch.profiler
    _, host_s = wall_s(lambda: run_path(x))
    ops = profile_ops(lambda: run_path(x))
    dev_ms = device_ms(ops)
    print(f"  one run: {host_s * 1e3:.1f} ms on the host clock; under "
          f"torch.profiler {dev_ms:.1f} ms of device time in {len(ops)} device "
          f"ops -> busy {dev_ms / (host_s * 1e3):.1%}")
    print("  top device ops: " + top_ops(ops, 8))

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

    xb = torch.from_numpy(blob_prints(range(16))).to(dev)
    _, msb = run_path(xb)
    cb = msb.count.cpu()
    print(f"  valid minutiae per blob print: {cb.tolist()}")
    if int((cb >= 8).sum()) < 12:
        fail("fewer than 12 of 16 blob prints yield >= 8 minutiae")

    # 5. the matcher
    d = matcher_phases(dev, build, card, msb, run_path)

    # 6. the file pipeline: images on disk to FRR/FAR/EER
    print("file pipeline (pipeline.run_all, skip_ssl=True, production "
          "matching configuration):")
    fp = file_pipeline_phase(dev, build, card)

    # 6b. every image file the JAX package reads, and a run over them
    print("formats (tests/fixtures/formats through the codec; run_all over "
          "a tree of progressive, colour, TIFF, PNG and BMP prints):")
    fmts = formats_phase(dev, build, card)
    print(json.dumps({"formats": {"card": card, **{
        k: fmts[k] for k in ("reader_ms", "run_all_s", "twin_run_all_s",
                             "eer", "visualize_orientation_ms", "seconds")}}}))

    # 7. the gallery: all-pairs scoring and 1:N identification
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    print("gallery (parallel/: all_pairs_unique, identify, identify_batch):")
    gal = gallery_phase(dev, build, card, create_mesh())

    # 8. the Gabor stage (preprocessing.gabor of the fingerprint config) on
    # the main path's batch, and the blob protocol with it
    def gabor_path(x):
        res = preprocess_fingerprint(x, gabor=True, gabor_params=dict(GABOR))
        ms = extract_minutiae(res.skeleton)
        return res, postprocess_minutiae(ms, res.skeleton)

    print("Gabor path (preprocess_fingerprint(gabor=True) -> extract -> "
          "postprocess, make_batch(128)):")
    gab = gabor_phase(dev, build, card, x, gabor_path, run_path)

    # 9. a run whose largest file is 2048x1024
    print("run_preprocessing on a directory with a 2048x1024 file:")
    large_frame_file_phase(dev, build)

    # 10. the ops off the enhance path
    print("ops off the enhance path, card against the CPU port:")
    ops_phase(dev)

    # 11. the SSL model at full width, its checkpoint, entry()
    print("SSL forward (EfficientNetV2-S, 756 -> 512 -> 256, predictor on):")
    ssl_fwd = ssl_forward_phase(dev, card)

    # 12. UNet++ at the config's filters and segment_images
    print("UNet++ (filters 64 .. 1024, 256x256) and segment_images:")
    unet = unet_phase(dev, card)

    # 13. run_all from a raw DBII/ + Nist/ tree, its kernel launches counted
    # (set to 0 just before, read just after)
    print("run_all(skip_ssl=False, train=False) from a raw tree:")
    raw = ssl_run_all_phase(dev, build, card)
    print(json.dumps({"ssl_front": {
        "card": card, "ssl_forward": ssl_fwd, "unet": unet,
        "run_all_raw": {k: raw[k] for k in ("run_all_s", "seconds",
                                             "coassignment", "emb_err",
                                             "eer", "figure")}}}))

    # 14. training: SSL on host and device views, UNet++, run_all(train=True)
    print("training (train/, classifier.augment_device, run_all(train=True)):")
    t0 = time.perf_counter()
    trained = train_phase(dev, build, card)
    print(f"  training phase {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"training": {"card": card, **{
        k: v for k, v in trained.items() if k != "run_all"},
        "run_all": {k: trained["run_all"][k] for k in (
            "run_all_s", "seconds", "eer", "gap", "steps")}}}))

    src = f"{PKG}/csrc"
    jax_ops = "multimodal_biometric_fingerprints_palms_tpu/ops"

    def entry(name, source, replaces, count, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": f"{src}/{source}",
                "replaces": replaces, "launches": count, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}

    # library_ms is null throughout: no single PyTorch call computes CLAHE,
    # a component filter, thinning, hypothesis scoring, NLM, the hybrid
    # threshold or the reconstruction tail
    kernels = [
        entry("clahe", "clahe.cu", f"{jax_ops}/pallas_kernels.py:1460",
              launches["clahe"], clahe_err, clahe_ms, clahe_plain_ms,
              clahe_bound),
        entry("cc_label_filter", "cc.cu", f"{jax_ops}/pallas_cc.py:552",
              launches["cc"], 0.0, cc_ms, cc_plain_ms, cc_bound),
        entry("zs_thin", "thin.cu", f"{jax_ops}/pallas_bitpack.py:382",
              launches["thin"], 0.0, thin_ms, thin_plain_ms, thin_bound),
        entry("hypothesis_scores", "match.cu",
              "multimodal_biometric_fingerprints_palms_tpu/matching/"
              "pallas_match.py:218", d["launches"], d["err"], d["ms"],
              d["plain_ms"], (d["bound_ms"], d["bound_by"])),
        entry("nlm_denoise", "nlm.cu", f"{jax_ops}/pallas_kernels.py:794",
              launches["nlm"], nlm_err, nlm_ms, nlm_plain_ms, nlm_bound),
        entry("binarize_front", "binarize.cu",
              f"{jax_ops}/pallas_kernels.py:1118", launches["binarize"],
              float(f_bad > 0), f_ms, f_plain_ms, f_bound),
        entry("open_erode_reconstruct", "morph.cu",
              f"{jax_ops}/pallas_bitpack.py:329", launches["morph"], 0.0,
              g_res["ms"], g_res["plain_ms"], g_res["bound"]),
    ]
    # for kernel D also: the device operations one wrapper call launches, its
    # time against the kernel it replaced (that one's input staging
    # included), and the largest score difference between the two
    kernels[3].update({key: d[key] for key in (
        "device_ops_per_call", "parent_ms", "max_abs_diff_parent")})
    # for kernels A, F and G likewise: device operations of one wrapper call
    # and the time of the kernel each replaced, taken in the same run
    kernels[0].update(device_ops_per_call=len(clahe_ops),
                      parent_ms=clahe_parent_ms)
    kernels[5].update(device_ops_per_call=len(f_ops), parent_ms=f_parent_ms,
                      sauvola_alone_ms=sv_ms,
                      sauvola_alone_parent_ms=sv_parent_ms)
    kernels[6].update(device_ops_per_call=g_res["device_ops_per_call"],
                      parent_ms=g_res["parent_ms"], device_ms=g_res["device_ms"])
    # launches in the file pipeline's stage that runs each kernel
    for k, counter in zip(kernels, ("clahe", "cc", "thin", "match", "nlm",
                                    "binarize", "morph")):
        stage = "matching" if counter == "match" else "preprocessing"
        k["file_pipeline_launches"] = fp["launches"][stage][counter]
    # launches in run_all over the formats tree (counts set to 0 just
    # before it and read just after)
    for k, counter in zip(kernels, ("clahe", "cc", "thin", "match", "nlm",
                                    "binarize", "morph")):
        k["formats_launches"] = fmts["launches"][counter]
    # kernel D's launches in the gallery's all-pairs sweep with the cascade
    kernels[3]["gallery_launches"] = gal["launches"]
    # kernel C beyond one block's shared memory (the device-memory form)
    kernels[2]["large_frames"] = c_large
    # launches of each kernel in run_all(skip_ssl=False) from a raw tree
    for k, counter in zip(kernels, ("clahe", "cc", "thin", "match", "nlm",
                                    "binarize", "morph")):
        k["ssl_run_all_launches"] = raw["launches"][counter]
    # and in run_all(skip_ssl=False, train=True), which trains first
    for k, counter in zip(kernels, ("clahe", "cc", "thin", "match", "nlm",
                                    "binarize", "morph")):
        k["train_run_all_launches"] = trained["run_all"]["launches"][counter]
    # launches of each kernel on the Gabor path (its counts set to 0 just
    # before it and read just after)
    for k, counter in zip(kernels, ("clahe", "cc", "thin", "match", "nlm",
                                    "binarize", "morph")):
        k["gabor_path_launches"] = gab["launches"][counter]
    for k in kernels:
        for key in ("ms", "plain_ms", "max_abs_err", "bound_ms"):
            if not math.isfinite(k[key]):
                fail(f"{k['name']} {key} not finite")
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on its path")
        if k["ms"] < k["bound_ms"]:
            fail(f"{k['name']}: {k['ms']:.4f} ms reads under its bound "
                 f"{k['bound_ms']:.4f} ms; the bound is miscounted")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
