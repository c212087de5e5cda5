"""Fixtures, inputs and tolerances of the kernels' card tests.

The card tests are marked ``card``; README's card section gives the
command that runs them (``pytest -m card`` over the eight test files of the
kernels' twins).

``card`` skips a test without a CUDA card. ``stages`` is the main path's
stage inputs on the card, made once a test module: ``make_batch(128)``
through ``preprocess_fingerprint``, and each kernel's input as the path
hands it over. ``chip_smoke.py`` times the kernels on the same inputs
and holds them to their twins there under the same tolerances.
Imports torch and the port only, so the card's machine needs nothing else.
"""

from __future__ import annotations

import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PARITY_FULL = ROOT / "tests" / "fixtures" / "parity_full"
BATCH = 128
CHUNK = 512                   # pairs per device chunk (the runner's default)
BIG_CHUNK = 4096
H_FULL = 300                  # RANSAC hypotheses of the full pass
SCREEN_ITERS = 32             # configs/config_matching.yml matching.screen_iters
FRR_GATES = dict(dist_thresh=30.0, orient_thresh=math.radians(30.0),
                 min_inliers=6)
FAR_GATES = dict(dist_thresh=15.0, orient_thresh=math.radians(10.0),
                 min_inliers=12)

# Kernels against their plain twins. Masks, labels, skeletons and counts
# exact. CLAHE (A): the LUTs agree exactly (all their sums are exact in
# float32 at these tile sizes); the blend may differ by one float32
# rounding, and a LUT may differ by one level only at a cdf*scale
# half-integer tie.
CLAHE_ATOL = 1.0 / 255.0 + 1e-6
CLAHE_MAX_OFF = 1e-3          # fraction of pixels further apart than 1e-6
# NLM (E) visits the offsets in its twin's order with the twin's rounding
# points, so the aim is 0; the slack is for expf against torch.exp landing
# on the two sides of a bf16 rounding boundary.
NLM_ATOL = 1e-5
NLM_MAX_OFF = 1e-4            # fraction of pixels allowed off by > 1e-6
# The hybrid threshold (F) follows its twin operation by operation except
# for the order of the 1,024-term patch mean and variance sums, which can
# move the `p_std >= 3/255` gate of a patch that sits on it.
F_MAX_MISMATCH = 1e-3         # fraction of mask pixels
# Hypothesis scores (D): counts exact; scores within 1e-6, because the
# warp's shuffle tree sums the K inlier scores in another order than the
# twin's sum.
D_ATOL = 1e-6
# Recall anchors (J): promote bits exact. Every rounding of the twin's
# anchors is reproduced, so no bit may differ.
J_MAX_MISMATCH = 0            # promote bits that may differ from the twin's


@pytest.fixture(scope="session")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stages(card):
    return stage_inputs(card)


def run_path(x):
    """The main path: ``preprocess_fingerprint`` -> ``extract_minutiae`` ->
    ``postprocess_minutiae``; (stage results, minutiae)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        extract_minutiae, postprocess_minutiae)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        preprocess_fingerprint)
    res = preprocess_fingerprint(x)
    return res, postprocess_minutiae(extract_minutiae(res.skeleton),
                                     res.skeleton)


def stage_inputs(dev) -> SimpleNamespace:
    """The kernels' real inputs at the main path's shapes, batch 128 of
    320x256: ``res`` (the path's stage results), ``clahe_in`` (clip, image)
    of the path's three CLAHE calls (normalize, segment, binarize),
    ``smooth`` (the binary mask smoothed, B's input), ``opened`` and
    ``marker`` (B's reach), ``gated`` (C's), ``img_eq`` (F's), ``fg``,
    ``kept`` (B's fill_holes) and ``cleaned`` (G's)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
        cuda_binarize, cuda_cc)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.components import (
        clean_mask)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.filters import (
        gaussian_blur)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.histogram import (
        clahe, percentile_stretch)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.morphology import (
        binary_erode, binary_opening)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        smooth_fingerprint_skeleton)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.enhance import (
        _quantize_u8)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        make_batch)
    x = torch.from_numpy(make_batch(BATCH)).to(dev)
    res, _ = run_path(x)
    smooth = smooth_fingerprint_skeleton(res.binary.float())
    opened = binary_opening(res.binary, 3, shape="ellipse")
    img_eq = clahe(_quantize_u8(res.segmented), clip_limit=2.5, grid=8)
    fg = cuda_binarize.binarize_foreground_cuda(img_eq)
    kept = cuda_cc.cc_filter_cuda(fg, "remove_small", 1, min_size=80)
    out = SimpleNamespace(
        x=x, res=res, smooth=smooth, opened=opened, img_eq=img_eq, fg=fg,
        kept=kept,
        clahe_in=[(2.5, _quantize_u8(percentile_stretch(x, 0.5, 99.5))),
                  (2.0, _quantize_u8(res.denoised)),
                  (2.5, _quantize_u8(res.segmented))],
        marker=binary_erode(opened, 3, shape="ellipse"),
        gated=clean_mask(smooth, 64, 80, connectivity=1)
        & (gaussian_blur(res.reliability, 2.0) > 0.1),
        cleaned=cuda_binarize.fill_holes_phase2(kept))
    torch.cuda.synchronize()
    return out


def matcher_gallery(dev):
    """Kernel D's gallery on the card: the 136 fixture templates
    (``tests/fixtures/parity_full``, 4 a user) and the main path's
    templates of 16 blob prints in one dataset; (dataset, the 512 pairs of
    a chunk: the blob prints' pairs, then the fixtures' genuine and
    impostor pairs, the fixtures' first 4,096 pairs)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.dataset import (
        MinutiaeDataset, genuine_pairs, impostor_pairs, load_dataset)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        blob_prints)
    _, blob = run_path(torch.from_numpy(blob_prints(range(16))).to(dev))
    fix = load_dataset(PARITY_FULL, max_per_user=4, device=dev)
    nfix, nblob = len(fix.matrices), blob.valid.shape[0]
    ds = MinutiaeDataset([], np.zeros(0), np.zeros(0), [], MinutiaeSet(
        *(torch.cat([f, b]) for f, b in zip(fix.stacked, blob))))
    fix_pairs = np.concatenate([genuine_pairs(fix), impostor_pairs(fix)])
    blob_pairs = np.asarray([(nfix + i, nfix + j) for i in range(nblob)
                             for j in range(i + 1, nblob)], np.int32)
    return (ds, np.concatenate([blob_pairs, fix_pairs])[:CHUNK],
            fix_pairs[:BIG_CHUNK])


def hypothesis_args(ds, pairs, p, scattered: bool = False) -> tuple:
    """Kernel D's arguments for ``pairs`` of ``ds`` under MatchParams
    ``p``, through the real path's statistics and sampling. ``scattered``:
    validity scattered over the slots, every 16th pair without a valid B
    slot, and two hypotheses a pair that put an A minutia onto the point
    the invalid B slots are displaced to (the kernel skips invalid B slots,
    and there one of them is the nearest neighbour)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        _apply_rigid, _pair_stats, sample_hypotheses)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        _gather)
    a, b = _gather(ds, pairs[:, 0]), _gather(ds, pairs[:, 1])
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


def anchor_tile(ds, first: int = 0, second: int | None = None, k: int = 64,
                tile: int = 64) -> tuple:
    """A screen tile of kernel J: templates ``first`` to ``first + tile`` of
    ``ds`` (A, repeat-major) against ``second`` to ``second + tile`` (B,
    tile-minor; by default the same block, a diagonal tile), as the
    gallery's blocked screen pairs them, with their slots cut to ``k`` or
    padded to it with invalid slots."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        _gather)
    idx = np.arange(tile * tile)
    a = _gather(ds, first + idx // tile)
    b = _gather(ds, (first if second is None else second) + idx % tile)
    return tuple(MinutiaeSet(*(resize_slots(x, k) for x in ms))
                 for ms in (a, b))


def resize_slots(x, k: int):
    """A (P, K, ...) field cut to its first ``k`` slots or padded with
    zeros (invalid slots) to ``k``."""
    if x.shape[1] >= k:
        return x[:, :k].contiguous()
    pad = torch.zeros((x.shape[0], k - x.shape[1]) + x.shape[2:],
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def anchor_args(a, b, p) -> tuple:
    """Kernel J's arguments for the pairs (a, b) under MatchParams ``p``:
    the weights and the early reject through ``sample_pairs``, as the
    screen hands them over (kernel I's on a card)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.cuda_match import (
        sample_pairs)
    wa, wb, _, _, _, reject, *_ = sample_pairs(a, b, p)
    return (a, b, wa, wb, reject, p)
