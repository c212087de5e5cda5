#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_biometric_fingerprints_palms_tpu_torch/csrc``
and drives the port's paths on the card. The kernels are held to their
plain twins by the card tests (``python3 -m pytest -m card`` over the
eight test files of the kernels' twins, as README's card section gives it);
this script holds each kernel to its twin once more on the main path's
inputs, times them and runs what no test and no benchmark cell holds:

- the kernels: one table of kernel ms, its largest difference from its
  plain twin under the card tests' tolerances (``tests/torch_card.py``),
  device time and device operations a call (``cudabench.tracing``), plain
  twin ms and bound (``cudabench/work.py``) at the main path's shapes (batch 128 of 320x256
  images of ``make_batch(128)``, the port's copy of the JAX benchmark's
  input, on real stage inputs; D at P=512, H=300, K=64; H and I at an
  identification call);
- the main path: ``preprocess_fingerprint`` -> ``extract_minutiae`` ->
  ``postprocess_minutiae`` on ``make_batch(128)``, each kernel's launches
  in one run (A x3, B x4, C, E, F, G x1, D, H, I none), its outputs, 4 images
  against the port on the CPU, and the minutiae of 16 blob prints;
- the 1:1 RANSAC matcher: the FRR/FAR/EER protocol of the reference golden
  (``tests/fixtures/parity_full_golden.json``) on the repository's 136
  templates with the cascade on and off, held to the golden's tolerances
  with its launches counted, and enhance -> match on 8 users x 2 sessions
  of synthetic prints under the production matching configuration;
- the file pipeline: ``pipeline.run_all(skip_ssl=True,
  demo_matching=False)`` from files on disk (``tools/polyu_set.py``: 160
  PolyU-shaped JPEGs of 320x240, a BMP, a colour PNG and a TIFF it must
  skip), counting each stage's kernel launches (A, B, C, E, F, G in
  preprocessing, D, H and I in matching), holding 4 images against the port
  on the CPU from the same files, checking every output file, the JSON
  schema, ``roc.png`` and the EER bounds, and printing each stage's seconds;
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
- a directory whose largest file is 2048x1024 through ``run_preprocessing``;
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
  ``run_all(skip_ssl=False, train=True)`` from a raw tree to EER;
- multi-GPU (``parallel.launch.run_ranks``): one NCCL rank a card runs the
  gallery's cascade sweep and ``identify_batch`` on the world mesh (equal
  to the gallery phase's results; kernel D's launches summed over ranks),
  ``train_ssl(mesh=world)`` for two steps at full width against
  ``train_ssl`` on one device (and the first step's gradient summed over
  ranks against one device's), and ``dryrun_multichip``; then two gloo
  ranks share one card and are held to the same results (NCCL refuses two
  ranks on one device), unless gloo refuses CUDA tensors.

Imports nothing of JAX or of the JAX package (nor OpenCV, PIL, PyYAML,
pandas or matplotlib). Prints the card's name and power limit, one JSON
line with the kernel table and each kernel's launches on the paths above,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero on
any failure, when no GPU is available, or outside a checkout of the
repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "multimodal_biometric_fingerprints_palms_tpu_torch"
# Skeleton agreement of the port on the card against the port on the CPU
# for the same images (same bound as tests/test_torch_enhance.py holds the
# port to against the JAX package): NLM's float sums and exp differ in the
# last bits between devices, which can move a ridge edge by one pixel.
MAX_SKEL_MISMATCH = 0.05      # of the CPU skeleton's pixels
MAX_COUNT_DIFF = 2            # valid minutiae per image

# Matcher. The chunk, the hypotheses, the gates and kernel D's tolerance
# are the card tests' (tests/torch_card.py), read once main() has checked
# the checkout.
GOLDEN = ROOT / "tests" / "fixtures" / "parity_full_golden.json"
# configs/config_matching.yml's values, as constants: the script imports
# nothing of the checkout before main() has checked that it is one
PRODUCTION = dict(ransac_iter=300, stop_inlier_ratio=0.15, seed=42,
                  peers=100, num_points=50, max_per_user=2, cascade=True)


# each kernel's counter (``build.KERNELS``): its source under csrc/ and the
# site of the JAX package it replaces
_JAX_OPS = "multimodal_biometric_fingerprints_palms_tpu/ops"
KERNEL_SITES = {
    "clahe": ("clahe.cu", f"{_JAX_OPS}/pallas_kernels.py:1460"),
    "cc": ("cc.cu", f"{_JAX_OPS}/pallas_cc.py:552"),
    "thin": ("thin.cu", f"{_JAX_OPS}/pallas_bitpack.py:382"),
    "match": ("match.cu", "multimodal_biometric_fingerprints_palms_tpu/"
              "matching/pallas_match.py:218"),
    "nlm": ("nlm.cu", f"{_JAX_OPS}/pallas_kernels.py:794"),
    "binarize": ("binarize.cu", f"{_JAX_OPS}/pallas_kernels.py:1118"),
    "morph": ("morph.cu", f"{_JAX_OPS}/pallas_bitpack.py:329"),
    "finish": ("finish.cu", "none (matching/ransac.py's finish is XLA's)"),
    "sample": ("sample.cu", "none (matching/ransac.py's statistics and "
               "sampling are XLA's)"),
    "anchor": ("anchor.cu", "none (matching/ransac.py's anchor_promote is "
               "plain jnp)"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]



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


def load_tool(name: str):
    """A script under ``tools/`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_table(dev, st) -> list:
    """One row a kernel call at the main path's shapes (``st``: the stage
    inputs of ``tests/torch_card.py``, batch 128 of 320x256; D at P=512,
    H=300, K=64 on the card tests' gallery; H and I at an identification
    call, P=1,024 (I also 4,050), H=300, K=64; J at a screen tile, P=4,096,
    8 anchors, K=64), for ``PERF.md``'s kernel
    table: ms a call of the kernel by CUDA events around back-to-back
    calls, its device time and device operations a call under
    ``cudabench.tracing.profiled``, its plain twin's ms, and the bound:
    ``cudabench.work.least_seconds`` of the call's bytes (each input read
    once, each output written once) and operations, by whichever of the two
    takes longer at the card's peaks. The device time is an estimate: the
    profile's window may take in an operation beside the calls or lose
    some of theirs, and where it holds fewer operations than calls the row
    has none (null). Each row also holds the kernel to its twin once, under
    the card tests' own tolerances (max_abs_err: the largest difference of
    any output). Fails where a kernel differs from its twin beyond them,
    and where the kernel's ms reads under its bound: such a bound is
    miscounted."""
    import numpy as np
    import torch
    from torch_card import (
        CLAHE_ATOL, CLAHE_MAX_OFF, D_ATOL, F_MAX_MISMATCH, FRR_GATES, H_FULL,
        J_MAX_MISMATCH, NLM_ATOL, NLM_MAX_OFF, SCREEN_ITERS, anchor_args,
        hypothesis_args, matcher_gallery)
    from cudabench import work
    from cudabench.tracing import profiled
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet, minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        cuda_match as cm)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams, _anchor_promote, _finish_match)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
        cuda_binarize, cuda_cc, cuda_kernels, cuda_morph, cuda_nlm, cuda_thin,
        denoise)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        users_gallery)
    npx = float(st.x.numel())
    finish_tool, sample_tool = load_tool("finish_check"), load_tool("sample_check")

    # the card tests' rules: (kernel's output, twin's output) ->
    # (max |d| over the outputs, within the tests' limits)
    outs = lambda r: [r] if isinstance(r, torch.Tensor) else list(r)

    def max_err(got, want) -> float:
        return max(float((x.double() - y.double()).abs().max()) if x.numel()
                   else 0.0 for x, y in zip(outs(got), outs(want)))

    def exact(got, want):       # masks, labels, skeletons, counts
        return max_err(got, want), all(
            x.dtype == y.dtype and torch.equal(x, y)
            for x, y in zip(outs(got), outs(want)))

    def near(atol, max_off):    # A and E: max_off of the pixels off by > 1e-6
        def rule(got, want):
            d = (got - want).abs()
            return float(d.max()), (bool(torch.isfinite(got).all())
                                    and float(d.max()) <= atol
                                    and float((d > 1e-6).float().mean())
                                    <= max_off)
        return rule

    def mismatch(got, want):    # F
        return max_err(got, want), \
            int((got != want).sum()) <= F_MAX_MISMATCH * got.numel()

    def scores(got, want):      # D: counts exact, scores within D_ATOL
        (sk, ck), (sp, cp) = got, want
        err = float((sk - sp).abs().max())
        return err, (torch.equal(ck, cp) and bool(torch.isfinite(sk).all())
                     and err <= D_ATOL)

    def bits(got, want):        # J: promote bits, J_MAX_MISMATCH may differ
        return max_err(got, want), (got.dtype == want.dtype and int(
            (got != want).sum()) <= J_MAX_MISMATCH)

    def tool(judge):            # H and I: their card tests' comparison
        return lambda got, want: (max_err(got, want), judge())

    # a component filter: mask in, mask out, about 10 operations a pixel a
    # label pass (neighbour tests, the union, the tally, the keep test)
    one_pass = (2.0 * npx, 10.0 * npx)

    def cc(name, m, mode, conn, cost, **kw):
        return (f"B {name}", "cc",
                lambda: cuda_cc.cc_filter_cuda(m, mode, conn, **kw),
                lambda: cuda_cc.cc_filter_plain(m, mode, conn, **kw), exact,
                cost)

    clahe_in = st.clahe_in[0][1]
    rows = [
        # image in, image out; per pixel the bin, four LUT reads and the blend
        ("A CLAHE, clip 2.5", "clahe",
         lambda: cuda_kernels.clahe_cuda(clahe_in, 2.5, 8),
         lambda: cuda_kernels.clahe_plain(clahe_in, 2.5, 8),
         near(CLAHE_ATOL, CLAHE_MAX_OFF), (8.0 * npx, 15.0 * npx)),
        cc("clean(64, 80) conn1", st.smooth, "clean", 1,
           (2.0 * npx, 20.0 * npx), min_size=64, max_size=80),
        cc("remove_small(80) conn1", st.fg, "remove_small", 1, one_pass,
           min_size=80),
        cc("fill_holes(150) conn1", st.kept, "fill_holes", 1, one_pass,
           max_size=150),
        cc("reach conn2", st.opened, "reach", 2, one_pass, marker=st.marker),
        cc("largest conn2", st.smooth, "largest", 2, one_pass),
        # cc_label writes int32 labels instead of a byte mask
        ("B cc_label conn2", "cc",
         lambda: cuda_cc.cc_label_cuda(st.smooth, 2),
         lambda: cuda_cc.cc_label_plain(st.smooth, 2), exact,
         (5.0 * npx, 10.0 * npx)),
        ("C thin, max_iters 128, prune", "thin",
         lambda: cuda_thin.zs_thin_cuda(st.gated, 128, True),
         lambda: cuda_thin.zs_thin_plain(st.gated, 128, True), exact,
         (2.0 * npx, thinning_work(st.gated))),
        ("E NLM, bf16", "nlm",
         lambda: cuda_nlm.nlm_denoise_cuda(st.res.normalized),
         lambda: denoise.nlm_denoise_plain(st.res.normalized),
         near(NLM_ATOL, NLM_MAX_OFF), work.nlm_work(*st.x.shape)),
        # float image in, byte mask out; per pixel two separable 25-tap box
        # means (x and x*x: 4 passes of 25 multiplies and 24 adds), the
        # threshold, and its share of the patch's histogram and Otsu scan
        ("F binarize front", "binarize",
         lambda: cuda_binarize.binarize_foreground_cuda(st.img_eq),
         lambda: cuda_binarize.binarize_foreground_plain(st.img_eq),
         mismatch, (5.0 * npx, 215.0 * npx)),
        ("F Sauvola alone", "binarize",
         lambda: cuda_binarize.sauvola_cuda(st.img_eq),
         lambda: cuda_binarize.sauvola_plain(st.img_eq), mismatch,
         (5.0 * npx, 212.0 * npx)),
        ("G open -> erode -> reconstruct", "morph",
         lambda: cuda_morph.open_erode_reconstruct_cuda(st.cleaned),
         lambda: cuda_morph.open_erode_reconstruct_plain(st.cleaned),
         exact, (2.0 * npx, opening_work(st.cleaned))),
    ]

    ds, pairs, _ = matcher_gallery(dev)
    d_args = hypothesis_args(ds, pairs,
                             MatchParams(ransac_iter=H_FULL, **FRR_GATES))
    rows.append((f"D hypothesis scores, P={len(pairs)}, H={H_FULL}", "match",
                 lambda: cm.hypothesis_scores_cuda(*d_args),
                 lambda: cm.hypothesis_scores_plain(*d_args), scores,
                 work.hypothesis_work(d_args[0].valid, d_args[1].valid, H_FULL)))

    # H and I: one probe against P templates of ``users_gallery``, its mate
    # among them, through the real path's statistics, sampling and kernel D
    k, p = 64, MatchParams(ransac_iter=H_FULL)
    for pn in (1024, 4050):
        gal = users_gallery(pn, 2, k=k, seed=11)
        a_np = {f: np.repeat(v[1:2], pn, axis=0) for f, v in gal.items()}
        b_np = {f: v[0::2] for f, v in gal.items()}
        if pn == 1024:
            h_args = finish_tool.finish_inputs(a_np, b_np, p, dev, special=False)
            want = _finish_match(*h_args)
            na, nb = h_args[5], h_args[6]
            scored = want.final_score > 0
            # 10 operations a distance the finish needs: two passes of each
            # valid A slot over the valid B slots of a scored pair, one pass
            # of each inlier over the valid A slots
            dists = float((2 * na * nb + want.n_inliers * na)[scored].sum())
            rows.append((f"H finish, P={pn}", "finish",
                         lambda: cm.finish_match_cuda(*h_args),
                         lambda: _finish_match(*h_args),
                         tool(lambda: finish_tool.ok(finish_tool.compare(h_args))),
                         (pn * (2 * k * (8 + 4 + 4 + 1) + 2 * k * 4 + 4 * 3 + 1)
                          + pn * H_FULL * (4 + 4 + 4 + 8)
                          + pn * (4 + 4 + 4 + 4 + 8),
                          10.0 * dists + 3.0 * pn * H_FULL)))
        a, b = minutiae_from_numpy(a_np, dev), minutiae_from_numpy(b_np, dev)
        # seven (P, K) planes of A and of B and the (H, 2) uniforms in, the
        # statistics and hypotheses out; three K-leaf scans and the
        # statistics a pair, a cos, a sin and about 20 more a hypothesis
        rows.append((f"I statistics and sampling, P={pn}", "sample",
                     lambda a=a, b=b: cm.sample_pairs_cuda(a, b, p),
                     lambda a=a, b=b: sample_tool.plain(a, b, p),
                     tool(lambda a=a, b=b: sample_tool.ok(
                         sample_tool.compare(a, b, p))),
                     (pn * (2 * k * (8 + 4 + 4 * 4 + 1) + 2 * k * 4 + 3 * 4 + 1
                            + H_FULL * (4 + 8 + 4)) + H_FULL * 8,
                      pn * (3 * k + 2 * k * 20) + pn * H_FULL * 60.0)))

    # J: one tile of the all-pairs screen, a block of 64 templates of
    # ``users_gallery`` (40 minutiae of 64 slots) against itself, 4,096
    # pairs, under the screen's parameters and kernel I's statistics
    gal = minutiae_from_numpy(users_gallery(32, 2, k=k, seed=13), dev)
    block = torch.arange(64, device=dev)
    j_args = anchor_args(
        MinutiaeSet(*(x[block.repeat_interleave(64)] for x in gal)),
        MinutiaeSet(*(x[block.repeat(64)] for x in gal)),
        MatchParams(ransac_iter=SCREEN_ITERS, full_iters=H_FULL,
                    min_inliers=6))
    pn = j_args[0].valid.shape[0]
    # the two templates' xy, orientation, type and validity, the weights
    # and the reject in, the bits out; 8 instructions a valid-slot distance
    # under each of the 8 anchors
    dists = float((8 * j_args[0].valid.sum(-1) * j_args[1].valid.sum(-1)).sum())
    rows.append((f"J recall anchors, P={pn}, K={k}", "anchor",
                 lambda: cm.anchor_pairs_cuda(*j_args),
                 lambda: _anchor_promote(*j_args), bits,
                 (pn * (2 * k * (8 + 4 + 4 + 1) + 2 * k * 4 + 2), 8.0 * dists)))

    calls, out = 10, []
    for name, counter, kern, twin, rule, (nbytes, ops) in rows:
        err, within = rule(kern(), twin())
        ms, plain_ms = time_ms(kern, 20), time_ms(twin, 2)
        with profiled(dev, []) as prof:
            for _ in range(calls):
                kern()
        dev_ops = prof.ops_within(*prof.window)
        dev_ms = (sum(e - s for _, s, e in dev_ops) / calls / 1e3
                  if len(dev_ops) >= calls else None)
        b_ms = work.least_seconds(nbytes, ops) * 1e3
        by = ("bytes" if work.least_seconds(nbytes, 0.0)
              >= work.least_seconds(0.0, ops) else "operations")
        dev_txt = ("no device time (the profile lost operations)"
                   if dev_ms is None else f"about {dev_ms:.4f} ms of device time")
        print(f"  {name}: kernel {ms:.4f} ms back to back (bound {b_ms:.4f} "
              f"ms by {by}, {b_ms / ms:.1%}); {dev_txt} in "
              f"{len(dev_ops) / calls:g} device ops a call; twin "
              f"{plain_ms:.4f} ms; max|d| from the twin {err:.3g}")
        if not within:
            fail(f"{name}: the kernel differs from its twin beyond the card "
                 f"tests' tolerances (max|d| {err:.3g})")
        if not (math.isfinite(ms) and math.isfinite(plain_ms)):
            fail(f"{name}: a time is not finite")
        if ms < b_ms:
            fail(f"{name}: {ms:.4f} ms reads under its bound {b_ms:.4f} ms; "
                 "the bound is miscounted")
        src, replaces = KERNEL_SITES[counter]
        out.append({"name": name, "counter": counter,
                    "source": f"{PKG}/csrc/{src}", "replaces": replaces,
                    "max_abs_err": err, "ms": ms, "device_ms_estimate": dev_ms,
                    "device_ops_per_call": len(dev_ops) / calls,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by})
    return out


# --- the matcher ------------------------------------------------------------


def protocol(ds, frr_p, far_p, cascade: bool, peers: int, seed: int,
             num_points: int) -> dict:
    """The FRR/FAR/EER protocol of the JAX package's ``runner.main``: every
    genuine pair under the FRR gates, the sampled impostor pairs under the
    FAR gates, 50-point threshold sweeps, interpolated EER."""
    from torch_card import CHUNK, SCREEN_ITERS
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


def expected_chunks(ds, pairs, params,
                    cascade: bool) -> tuple[int, int, int]:
    """Kernel-D, kernel-H and kernel-J launches ``match_pair_indices`` makes
    for ``pairs``: D once a screen chunk and once a full-pass chunk of the
    promoted pairs, H once a full-pass chunk, J once a screen chunk. Kernel
    I launches as D does."""
    from torch_card import CHUNK, SCREEN_ITERS
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        screen_pair_indices)
    chunks = lambda n: -(-n // CHUNK)
    if not cascade or params.ransac_iter <= SCREEN_ITERS:
        return chunks(len(pairs)), chunks(len(pairs)), 0
    promoted = screen_pair_indices(ds, pairs, params, CHUNK, SCREEN_ITERS)
    print(f"    screen promoted {int(promoted.sum())} of {len(pairs)} pairs")
    full = chunks(int(promoted.sum()))
    return chunks(len(pairs)) + full, full, chunks(len(pairs))


def golden_phase(dev, build) -> None:
    """The reference golden's protocol on the 136 fixture templates, cascade
    off and on, each run's launches counted."""
    import numpy as np
    from torch_card import PARITY_FULL
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
        build.reset_launches()
        run = protocol(ds, frr_p, far_p, cascade, peers=100, seed=42,
                       num_points=pr["num_points"])
        launches[cascade] = build.launches()
        (dg, hg, jg), (di, hi, ji) = (
            expected_chunks(ds, run["g_pairs"], frr_p, cascade),
            expected_chunks(ds, run["i_pairs"], far_p, cascade))
        want = {**dict.fromkeys(build.KERNELS, 0), "match": dg + di,
                "finish": hg + hi, "sample": dg + di, "anchor": jg + ji}
        print(f"    launches {launches[cascade]}; expected {want}")
        if launches[cascade] != want:
            fail(f"cascade={cascade}: launch counts {launches[cascade]}, "
                 f"expected {want}")
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


def blob_protocol_phase(dev, run_path, build) -> None:
    """Enhance -> extract -> JSON -> dataset -> match on 8 users x 2 sessions
    of blob prints (tests/test_end_to_end_eer.py's set, without its JPEG
    round trip), under the production matching configuration."""
    import numpy as np
    import torch
    from torch_card import FAR_GATES, FRR_GATES
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
    build.reset_launches()
    mk = lambda gates: MatchParams(ransac_iter=pr["ransac_iter"],
                                   stop_inlier_ratio=pr["stop_inlier_ratio"],
                                   seed=pr["seed"], **gates)
    run = protocol(ds, mk(FRR_GATES), mk(FAR_GATES), pr["cascade"],
                   pr["peers"], pr["seed"], pr["num_points"])
    print(f"    launches {build.launches()}")
    gap = float(run["genuine"].mean() - run["impostor"].mean())
    print(f"    EER {run['eer']:.4f}, genuine - impostor mean {gap:.4f}")
    if len(ds.users) != 8 or len(run["g_pairs"]) != 8:
        fail("blob protocol: expected 8 users with 2 templates each")
    if build.launches()["match"] == 0:
        fail("blob protocol did not launch kernel D")
    if not (np.isfinite(run["genuine"]).all()
            and np.isfinite(run["impostor"]).all()):
        fail("blob protocol: non-finite scores")
    if gap < 0.3 or run["eer"] > 0.13:
        fail(f"blob protocol: genuine - impostor mean {gap:.4f} (>= 0.3), "
             f"EER {run['eer']:.4f} (<= 0.13)")



def matcher_phases(dev, build, run_path) -> None:
    print("golden protocol (tests/fixtures/parity_full, RANSAC 300):")
    golden_phase(dev, build)
    print("enhance -> match (8 users x 2 sessions of blob prints, "
          "production configuration):")
    blob_protocol_phase(dev, run_path, build)


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

    build.reset_launches()
    torch.cuda.synchronize()
    res, ms = run_path(x)
    torch.cuda.synchronize()
    launches = build.launches()
    print(f"  launches in one run with Gabor on: {launches}")
    expected = {"clahe": 3, "cc": 4, "thin": 1, "match": 0, "nlm": 1,
                "binarize": 1, "morph": 1, "finish": 0, "sample": 0,
                "anchor": 0}
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
            build.reset_launches()
            stats, secs = wall_s(lambda: prun.run_preprocessing(
                root / "sorted", root / "processed", batch_size=4,
                debug=False))
            launches = build.launches()
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
                "binarize": 1, "morph": 1, "finish": 0, "sample": 0,
                "anchor": 0}
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
            build.reset_launches()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            launches[name] = build.launches()
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
# in the all-baseline twin run: the progressive JPEGs their baseline twin,
# every other file a PNG the port writes from its pixels
FORMAT_PRINTS = ["progressive.jpg", "progressive_colour.jpg", "none.tif",
                 "deflate.tif", "packbits.tif", "grey16.png", "palette.png",
                 "adam7.png", "bmp32.bmp", "rle8.bmp", "exif_o6.png",
                 "exif_o3.tif", "jpeg_ycbcr.tif", "cmyk.jpg", "g4.tif",
                 "lzw.tif"]
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
    if stem.startswith(("jpeg_cmyk", "jpeg_ycck")):
        return "CMYK and YCCK JPEG"
    if stem.startswith("jpeg_rgb_coded"):
        return "RGB-coded JPEG"
    if stem.startswith(("tiff_jpeg", "tiff_fill_order_2_jpeg")):
        return "TIFF JPEG"
    if stem.startswith("tiff_ccitt") or stem.startswith(tuple(
            f"tiff_fill_order_2_{c}" for c in ("rle", "g3", "g4"))):
        return "TIFF CCITT"
    if stem.startswith(("tiff_ycbcr", "tiff_cmyk", "tiff_cielab")):
        return "TIFF YCbCr, CMYK, CIELab"
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
    orientation, a TIFF of YCbCr JPEG strips, an Adobe CMYK JPEG and a
    CCITT Group 4 TIFF), and over its twin tree (each progressive JPEG's
    baseline twin, every other file a PNG of its pixels, the LZW TIFF the
    JPEG it was decoded from). Fails unless only the corrupt TIFF is skipped, each
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
                base = FORMATS_DIR / "prints" / f"base_{kind}"
                if base.is_file():
                    twin, twin_ext = base.read_bytes(), ".jpg"
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
            build.reset_launches()
            os.chdir(path)
            try:
                res, t_all = wall_s(lambda: pipeline.run_all(
                    str(path), skip_ssl=True, demo_matching=False))
            finally:
                os.chdir(cwd)
            runs[tree] = dict(res=res, t=t_all, launches=build.launches())
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
    from torch_card import CHUNK, D_ATOL, H_FULL, SCREEN_ITERS
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
    calls = -(-tiles // (G._SCREEN_PAIRS // GALLERY_BLOCK ** 2))
    chunks = lambda k: -(-k // GALLERY_CHUNK)
    gib = lambda b: b / 2 ** 30
    print(f"  {n} templates ({GALLERY_USERS} users x {GALLERY_SAMPLES}), "
          f"{len(pairs)} unique pairs, {int(same.sum())} genuine; mesh "
          f"{mesh.devices}; screen: {tiles} tiles of {GALLERY_BLOCK ** 2} pairs "
          f"in {calls} calls")

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
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        scores, secs = wall_s(lambda: G.all_pairs_unique(
            gal, mesh, params, chunk=GALLERY_CHUNK, cascade=cascade,
            screen_iters=SCREEN_ITERS, anchors=anchors))
        launches = build.launches()
        peak = torch.cuda.max_memory_allocated()
        promoted = promoted_slots(gal, params, anchors) if cascade else None
        full = chunks(int(promoted.sum()) if cascade else len(pairs))
        want = calls + full if cascade else full
        g_mean, i_mean = scores[same].mean(), scores[~same].mean()
        share = (f"promoted {int(promoted.sum())} ({promoted.mean():.4%}); "
                 if cascade else "")
        print(f"  {name}: {secs:.3f} s, {len(pairs) / secs:.1f} pairs/s; "
              f"{share}kernel D launches {launches['match']} (expected "
              f"{want}); peak device memory {gib(peak):.3f} GiB; genuine "
              f"mean {g_mean:.4f}, impostor mean {i_mean:.6f}")
        anchored = calls if cascade and anchors else 0
        if launches != {**dict.fromkeys(build.KERNELS, 0), "match": want,
                        "finish": full, "sample": want, "anchor": anchored}:
            fail(f"gallery {name}: launch counts {launches}, expected {want} "
                 f"kernel-D and kernel-I calls, {full} kernel-H calls, "
                 f"{anchored} kernel-J calls and nothing else")
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
    build.reset_launches()
    _, secs = wall_s(lambda: [G.identify(probe, gp, mesh, p, chunk=IDENT_CHUNK)
                              for _ in range(reps)])
    one_ms = secs / reps * 1e3
    one_launches = build.launches()["match"] // reps
    one_peak = torch.cuda.max_memory_allocated()
    probes = G.take_templates(gd, torch.arange(IDENT_PROBES, device=dev))
    batch = G.identify_batch(probes, gp, mesh, p, chunk=IDENT_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    _, secs = wall_s(lambda: G.identify_batch(probes, gp, mesh, p,
                                              chunk=IDENT_CHUNK))
    batch_ms = secs / IDENT_PROBES * 1e3
    batch_launches = build.launches()["match"]
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
                identify_batch_ms=batch_ms,
                cascade_scores=runs["cascade on"]["scores"],
                identify_batch=batch.cpu())


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
        build.reset_launches()
        os.chdir(root)
        try:
            res, t_all = wall_s(lambda: pipeline.run_all(
                str(data), classifier_config=str(cfg), train=False,
                demo_matching=False))
        finally:
            os.chdir(cwd)
        launches = build.launches()
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
        build.reset_launches()
        os.chdir(root)
        try:
            res, t_all = wall_s(lambda: pipeline.run_all(
                str(data), classifier_config=str(cfg), train=True,
                demo_matching=False))
        finally:
            os.chdir(cwd)
        launches = build.launches()
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


# --- multi-GPU: the gallery and data-parallel SSL training over ranks ----------

MULTI_SSL_BATCH = 16          # global batch of 224x224 host views
MULTI_SSL_LR = 1e-5           # configs/config_classifier.yml ssl.training.lr
MULTI_GRAD_RTOL = 1e-3        # ||ranks' summed gradient - one device's|| / ||one device's||
MULTI_TIMEOUT = 300           # seconds a launch may take, its ranks' start included
MULTI_COLLECTIVE_REPS = 10


def _multi_ssl(mesh, dev) -> dict:
    """Data-parallel SSL training at full width on ``mesh`` (None: one
    device ``dev``, no mesh) from the weights seed 0 gives, on
    ``TRAIN_CMP_STEPS`` global batches of ``MULTI_SSL_BATCH`` host views
    from ``default_rng(3)``: first the gradient of the first step at those
    weights (``ssl_loss_and_grads``, summed over the ranks), then one
    epoch of ``train_ssl(mesh=mesh)`` (seed 0, lr ``MULTI_SSL_LR``, one
    warm-up epoch: lr 0 at step 0) with its working directory and
    checkpoints in a temporary directory of this process. Returns the
    gradient, the epoch's loss, the step times, the state after on the
    host and the checkpoints this process wrote."""
    import os
    import numpy as np
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
        SSLModel, seed_weights, ssl_variables_from_state)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.collectives import (
        rank_rows)
    from multimodal_biometric_fingerprints_palms_tpu_torch.train import (
        ssl_train)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry
    g = np.random.default_rng(3)
    views = [tuple(g.random((MULTI_SSL_BATCH, 224, 224), np.float32)
                   for _ in range(2)) for _ in range(TRAIN_CMP_STEPS)]
    model = seed_weights(SSLModel(**SSL_FULL), 0).to(dev)
    first = threefry.split(threefry.key(0))[1]      # train_ssl's first key
    xi, xj = (torch.from_numpy(np.ascontiguousarray(rank_rows(x, mesh))).to(
        dev) for x in views[0])
    _, grads = ssl_train.ssl_loss_and_grads(model, xi, xj, first, mesh=mesh)
    grads = [t.cpu() for t in grads]
    stamps: list = []

    def batches():
        for v in views:
            stamps.append(time.perf_counter())
            yield v
        stamps.append(time.perf_counter())

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            (state, history), train_s = wall_s(lambda: ssl_train.train_ssl(
                model, batches, TRAIN_CMP_STEPS, epochs=1, lr=MULTI_SSL_LR,
                warmup_epochs=1, seed=0, save_dir="ckpt", mesh=mesh,
                device=dev))
            written = sorted(os.listdir("ckpt")) if os.path.isdir(
                "ckpt") else []
        finally:
            os.chdir(cwd)
    host = lambda ts: [t.detach().cpu() for t in ts]
    return dict(grads=grads, history=history, train_s=train_s,
                step_s=[b - a for a, b in zip(stamps, stamps[1:])],
                params=host(model.parameters()),
                mu=host(state.opt_state.mu), nu=host(state.opt_state.nu),
                stats=ssl_variables_from_state(model.state_dict())[
                    "batch_stats"], written=written)


def gloo_probe_rank() -> str:
    """One rank of the probe: a row gather and an all-reduce of CUDA
    tensors on this rank's card. Returns "" when both ran, else gloo's
    refusal; any other failure is the rank's own."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.collectives import (
        all_reduce_sum, gather_rows)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    mesh = create_mesh(device="cuda")
    x = torch.full((2, 3), float(mesh.rank + 1), device=mesh.device)
    try:
        got = gather_rows(x, mesh)
        total = all_reduce_sum(x.clone(), mesh)
    except RuntimeError as e:
        if not any(w in str(e).lower() for w in ("cuda", "device")):
            raise
        return str(e).strip().splitlines()[0]
    ranks = torch.arange(1, mesh.size + 1, dtype=x.dtype, device=mesh.device)
    if not (torch.equal(got, ranks.repeat_interleave(2)[:, None].expand(-1, 3))
            and torch.equal(total, torch.full_like(x, float(ranks.sum())))):
        raise AssertionError(f"gloo's collectives on CUDA tensors: {got}, "
                             f"{total}")
    return ""


def multi_gpu_rank() -> dict:
    """One rank of ``multi_gpu_phase``: the all-pairs sweep with the cascade
    and ``identify_batch`` on the world mesh (kernel D's launches counted
    from 0 just before and read just after), the data-parallel SSL
    training (``_multi_ssl``), then the time of the two collectives the
    paths issue, at their sizes."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch_card import H_FULL, SCREEN_ITERS
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet, minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
        gallery as G)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.collectives import (
        all_reduce_sum, gather_rows)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        users_gallery)
    build.load_library()
    mesh = create_mesh(device="cuda")       # the card gloo ranks share too
    w = mesh.size
    g40 = minutiae_from_numpy(users_gallery(GALLERY_USERS, GALLERY_SAMPLES,
                                            n_min=40, seed=0))
    p = MatchParams(ransac_iter=H_FULL)
    sweep = lambda gal: G.all_pairs_unique(
        gal, mesh, p, chunk=GALLERY_CHUNK, cascade=True,
        screen_iters=SCREEN_ITERS)
    sweep(MinutiaeSet(*(x[:GALLERY_WARMUP] for x in g40)))
    gp = G.pad_gallery(g40, IDENT_CHUNK)
    n_local = gp.valid.shape[0] // w
    chunk = IDENT_CHUNK if n_local % IDENT_CHUNK == 0 else n_local
    probes = G.take_templates(g40, np.arange(IDENT_PROBES))
    build.reset_launches()
    scores, sweep_s = wall_s(lambda: sweep(g40))
    shard = G.shard_gallery(gp, mesh)
    batch, ident_s = wall_s(lambda: G.identify_batch(probes, shard, mesh, p,
                                                     chunk=chunk))
    launches = build.launches()
    ssl = _multi_ssl(create_mesh(axis_name="data", device="cuda"),
                     mesh.device)
    # the collectives at the sizes the paths give them: identify_batch's
    # (P, N / W) gather, and the SSL step's one gradient all-reduce
    blocks = torch.zeros(IDENT_PROBES, n_local, device=mesh.device)
    grads = torch.zeros(sum(t.numel() for t in ssl["params"]),
                        device=mesh.device)
    gather_ms = 1e3 * wall_s(lambda: [gather_rows(blocks, mesh) for _ in
                                      range(MULTI_COLLECTIVE_REPS)])[1] / \
        MULTI_COLLECTIVE_REPS
    reduce_ms = 1e3 * wall_s(lambda: [all_reduce_sum(grads, mesh) for _ in
                                      range(MULTI_COLLECTIVE_REPS)])[1] / \
        MULTI_COLLECTIVE_REPS
    return dict(rank=mesh.rank, size=w, backend=dist.get_backend(),
                device=str(mesh.device), scores=scores, sweep_s=sweep_s,
                identify=batch.cpu(), identify_s=ident_s, chunk=chunk,
                launches=launches, gather_ms=gather_ms, reduce_ms=reduce_ms,
                ssl=ssl)


def _multi_check(name, ranks, gal, ref, card) -> dict:
    """Every rank's results against the one-device ones; fails beyond the
    bounds. Returns the worst differences."""
    import numpy as np

    def rel_norm(want, got):
        num = sum(float(((b.double() - a.double()) ** 2).sum())
                  for a, b in zip(want, got))
        den = sum(float((a.double() ** 2).sum()) for a in want)
        return (num / den) ** 0.5

    def tree_max(a, b):
        if isinstance(a, dict):
            return max(tree_max(a[k], b[k]) for k in a)
        return float(np.abs(a - b).max())

    worst = dict(scores=0.0, identify=0.0, grad=0.0, loss=0.0, stats=0.0,
                 mu=0.0, nu=0.0, moves=0.0, params=0.0)
    start = ref["start"]
    for r in ranks:
        s = r["ssl"]
        worst["scores"] = max(worst["scores"], float(np.abs(
            r["scores"] - gal["cascade_scores"]).max()))
        worst["identify"] = max(worst["identify"], float(
            (r["identify"] - gal["identify_batch"]).abs().max()))
        worst["grad"] = max(worst["grad"], rel_norm(ref["grads"],
                                                    s["grads"]))
        worst["loss"] = max(worst["loss"], max(
            abs(a - b) for a, b in zip(s["history"], ref["history"])))
        worst["stats"] = max(worst["stats"], tree_max(ref["stats"],
                                                      s["stats"]))
        worst["mu"] = max(worst["mu"], rel_norm(ref["mu"], s["mu"]))
        worst["nu"] = max(worst["nu"], rel_norm(ref["nu"], s["nu"]))
        worst["moves"] = max(worst["moves"], rel_norm(
            [a - b for a, b in zip(ref["params"], start)],
            [a - b for a, b in zip(s["params"], start)]))
        worst["params"] = max(worst["params"], max(
            float((a - b).abs().max()) for a, b in zip(ref["params"],
                                                       s["params"])))
    par_bound = 2 * MULTI_SSL_LR + 1e-6
    writers = [r["rank"] for r in ranks if r["ssl"]["written"]]
    print(f"  {name}: all_pairs_unique scores max |d| {worst['scores']:.3g} "
          f"and identify_batch max |d| {worst['identify']:.3g} against the "
          f"gallery phase (bound 0); the first step's gradient summed over "
          f"ranks {worst['grad']:.3g} (relative norm, bound "
          f"{MULTI_GRAD_RTOL:g}); train_ssl(mesh) against train_ssl on one "
          f"device, {TRAIN_CMP_STEPS} steps: loss max |d| {worst['loss']:.3g} (bound "
          f"{TRAIN_LOSS_ATOL:g}), running statistics {worst['stats']:.3g} "
          f"({TRAIN_STATS_ATOL:g}); Adam's mu {worst['mu']:.3g}, nu "
          f"{worst['nu']:.3g} ({TRAIN_MOMENT_RTOL:g}, relative norm); the "
          f"parameters' moves {worst['moves']:.3g} ({TRAIN_MOVE_RTOL:g}); "
          f"parameters max |d| {worst['params']:.3g} ({par_bound:g}); "
          f"checkpoints {ranks[0]['ssl']['written']} written by ranks "
          f"{writers} ({card})")
    if worst["scores"] or worst["identify"]:
        fail(f"multi-GPU {name}: the sharded gallery differs from one device")
    if writers != [0] or ranks[0]["ssl"]["written"] != ref["written"]:
        fail(f"multi-GPU {name}: checkpoints written by ranks {writers}: "
             f"{[r['ssl']['written'] for r in ranks]}, one device "
             f"{ref['written']}")
    if not (worst["grad"] <= MULTI_GRAD_RTOL
            and worst["loss"] <= TRAIN_LOSS_ATOL
            and worst["stats"] <= TRAIN_STATS_ATOL
            and worst["mu"] <= TRAIN_MOMENT_RTOL
            and worst["nu"] <= TRAIN_MOMENT_RTOL
            and worst["moves"] <= TRAIN_MOVE_RTOL
            and worst["params"] <= par_bound):
        fail(f"multi-GPU {name}: data-parallel SSL beyond the bounds")
    return worst


def multi_gpu_phase(dev, build, card, gal) -> dict:
    """The port's multi-rank paths on W = ``torch.cuda.device_count()``
    NCCL ranks, one a card (``parallel.launch.run_ranks``): the all-pairs
    sweep with the cascade and ``identify_batch`` (64 probes, 1,536
    templates) on the world mesh, equal to ``gallery_phase``'s results;
    ``train_ssl(mesh=world)`` at full width against ``train_ssl`` on one
    device from the same weights and views (``_multi_ssl``);
    ``dryrun_multichip(W)``. Then two ranks on the one card over gloo with
    CUDA tensors (NCCL refuses two ranks on one device), held to the same
    results. Only gloo refusing CUDA tensors in the probe's collectives
    (``gloo_probe_rank``) skips that part; a rank that fails, dies or
    outlasts its time limit fails the script. Returns kernel D's launches
    summed over the NCCL ranks."""
    import torch
    from torch_card import H_FULL
    from multimodal_biometric_fingerprints_palms_tpu_torch import entry
    from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
        SSLModel, seed_weights)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.launch import (
        run_ranks)
    t_phase = time.perf_counter()
    w = torch.cuda.device_count()
    ref, ref_s = wall_s(lambda: _multi_ssl(None, dev))
    ref["start"] = [p.detach() for p in seed_weights(SSLModel(**SSL_FULL),
                                                     0).parameters()]
    print(f"  one device: the first step's gradient and train_ssl over "
          f"{TRAIN_CMP_STEPS} steps at full width, batch {MULTI_SSL_BATCH}, "
          f"in {ref_s:.2f} s (steps "
          f"{', '.join(f'{1e3 * s:.2f}' for s in ref['step_s'])} ms)")

    def launch(n, backend, timeout):
        ranks, secs = wall_s(lambda: run_ranks(
            multi_gpu_rank, n, device="cuda", backend=backend,
            timeout=timeout))
        d = sum(r["launches"]["match"] for r in ranks)
        h = sum(r["launches"]["finish"] for r in ranks)
        i_launches = sum(r["launches"]["sample"] for r in ranks)
        j_launches = sum(r["launches"]["anchor"] for r in ranks)
        other = {k: sum(r["launches"][k] for r in ranks)
                 for k in build.KERNELS if k not in ("match", "finish",
                                                     "sample", "anchor")}
        r0 = ranks[0]
        print(f"  {n} rank(s) over {r0['backend']} on "
              f"{', '.join(r['device'] for r in ranks)}: launch "
              f"{secs:.2f} s; all_pairs_unique (cascade on, RANSAC {H_FULL}) "
              f"{max(r['sweep_s'] for r in ranks):.3f} s; identify_batch "
              f"({IDENT_PROBES} probes, chunk {r0['chunk']}) "
              f"{max(r['identify_s'] for r in ranks):.3f} s; train_ssl "
              f"{r0['ssl']['train_s']:.2f} s, steps "
              f"{', '.join(f'{1e3 * s:.2f}' for s in r0['ssl']['step_s'])} "
              f"ms; collectives: gather of ({IDENT_PROBES}, "
              f"{1536 // n}) {max(r['gather_ms'] for r in ranks):.3f} ms, "
              f"all-reduce of the SSL gradient "
              f"{max(r['reduce_ms'] for r in ranks):.3f} ms; kernel D "
              f"launches summed over ranks {d}")
        if d <= 0 or h <= 0 or i_launches != d or j_launches <= 0 \
                or any(other.values()):
            fail(f"multi-GPU {n} ranks: kernel D launches {d}, kernel H "
                 f"{h}, kernel I {i_launches}, kernel J {j_launches}, "
                 f"others {other}")
        return ranks, secs, d

    ranks, secs, d = launch(w, None, MULTI_TIMEOUT)
    worst = _multi_check(f"{w} NCCL rank(s)", ranks, gal, ref, card)
    line, dry_s = wall_s(lambda: entry.dryrun_multichip(w))
    print(f"  dryrun_multichip({w}) in {dry_s:.2f} s")
    if not (line.startswith(f"dryrun_multichip({w}): ssl loss=")
            and line.endswith(" ok")):
        fail("dryrun_multichip: its line")
    out = dict(ranks=w, backend=ranks[0]["backend"], launches=d,
               launch_s=secs, sweep_s=max(r["sweep_s"] for r in ranks),
               identify_s=max(r["identify_s"] for r in ranks),
               ssl_step_ms=[1e3 * s for s in ranks[0]["ssl"]["step_s"]],
               one_device_ssl_step_ms=[1e3 * s for s in ref["step_s"]],
               gather_ms=max(r["gather_ms"] for r in ranks),
               reduce_ms=max(r["reduce_ms"] for r in ranks),
               worst=worst, dryrun_s=dry_s, dryrun=line)
    # two ranks on the one card: NCCL refuses a device shared by two ranks;
    # gloo moves CUDA tensors through the host, if it serves them at all
    if w == 1:
        refused = [r for r in run_ranks(gloo_probe_rank, 2, device="cuda",
                                        backend="gloo", timeout=120) if r]
        if refused:
            print("  two ranks on one card over gloo: not run (gloo refused "
                  f"CUDA tensors: {refused[0]})")
            out["two_on_one"] = dict(ran=False, error=refused[0])
        else:
            two, secs2, d2 = launch(2, "gloo", MULTI_TIMEOUT)
            out["two_on_one"] = dict(
                ran=True, launches=d2, launch_s=secs2,
                sweep_s=max(r["sweep_s"] for r in two),
                identify_s=max(r["identify_s"] for r in two),
                ssl_step_ms=[1e3 * s for s in two[0]["ssl"]["step_s"]],
                gather_ms=max(r["gather_ms"] for r in two),
                reduce_ms=max(r["reduce_ms"] for r in two),
                worst=_multi_check("2 gloo ranks on one card", two, gal,
                                   ref, card))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  multi-GPU phase {out['seconds']:.1f} s on {card}")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a GPU")
    if not (ROOT / PKG).is_dir() or not GOLDEN.is_file():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

    import torch_card
    from torch_card import run_path
    from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        preprocess_fingerprint)
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        extract_minutiae, postprocess_minutiae)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        blob_prints)

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

    # 3. the kernels timed on the main path's stage inputs (its first run)
    st = torch_card.stage_inputs(dev)
    x = st.x
    print("kernels at the main path's shapes (the card tests hold them to "
          "their twins):")
    table = kernel_table(dev, st)

    # 4. the main path: each kernel's launches in one run, and its outputs
    print("main path:")
    build.reset_launches()
    res, ms = run_path(x)
    main_launches = build.launches()
    print(f"  launches in one run: {main_launches}")
    expected = {"clahe": 3, "cc": 4, "thin": 1, "match": 0, "nlm": 1,
                "binarize": 1, "morph": 1, "finish": 0, "sample": 0,
                "anchor": 0}
    if main_launches != expected:
        fail(f"main path launch counts {main_launches}, expected {expected}")
    if res.skeleton.shape != x.shape or res.skeleton.dtype != torch.bool:
        fail("skeleton shape/dtype")
    for f in ("normalized", "denoised", "segmented", "orientation",
              "reliability"):
        if not torch.isfinite(getattr(res, f)).all():
            fail(f"non-finite {f}")
    if ms.xy.shape != (x.shape[0], 64, 2) or not torch.isfinite(ms.xy).all():
        fail("minutiae xy shape or values")
    counts = ms.count.cpu()
    print(f"  valid minutiae per image (make_batch): min {int(counts.min())}, "
          f"median {float(counts.float().median()):.0f}, max {int(counts.max())}")
    if int((counts > 0).sum()) < x.shape[0] * 3 // 4:
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
    matcher_phases(dev, build, run_path)
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

    # 15. multi-GPU: the sharded gallery, data-parallel SSL training and the
    # dry run over one rank a card (NCCL), then two ranks on one card (gloo)
    print("multi-GPU (parallel.launch.run_ranks: the gallery on the world "
          "mesh, data-parallel SSL, dryrun_multichip):")
    multi = multi_gpu_phase(dev, build, card, gal)
    print(json.dumps({"multi_gpu": {"card": card, **multi}}))

    # each kernel's launches on the paths above (their counts set to 0 just
    # before each and read just after)
    matcher = ("match", "finish", "sample", "anchor")
    launches = {
        "file_pipeline": {k: fp["launches"][
            "matching" if k in matcher else "preprocessing"][k]
            for k in build.KERNELS},
        "formats": fmts["launches"], "gabor_path": gab["launches"],
        "ssl_run_all": raw["launches"],
        "train_run_all": trained["run_all"]["launches"],
        # kernel D in the gallery's all-pairs sweep with the cascade, and
        # summed over the ranks of the multi-GPU phase's sweep and
        # identify_batch
        "gallery": {"match": gal["launches"]},
        "multi_gpu": {"match": multi["launches"]},
    }
    # each row's launches on its kernel's path: the main path for the
    # preprocessing kernels, the file pipeline's matching for D, H, I and J
    for row in table:
        row["main_path_launches"] = main_launches[row["counter"]]
        row["file_pipeline_launches"] = launches["file_pipeline"][row["counter"]]
        if not (row["main_path_launches"] if row["counter"] not in matcher
                else row["file_pipeline_launches"]):
            fail(f"{row['name']}: its kernel was not launched on its path")
    print(f"card: {card}")
    print(json.dumps({"kernels": table, "launches": launches}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
