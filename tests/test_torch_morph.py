"""Kernel G's function on the CPU (``ops.cuda_morph``): the binarize tail's
reconstruction is the identity, so the tail is the 3x3-cross opening; and
the kernel's word algebra (``open_cross_words_plain``: bands, halos, funnel
shifts, padding bits) equals the plain twin. All exact, on masks made from a
numpy seed, ragged widths included. (The JAX package's Pallas kernel is held
to the opening in ``tests/test_torch_binarize.py``.) Marked ``card``: kernel
G against the twin and the word algebra on the card, exact."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from multimodal_biometric_fingerprints_palms_tpu_torch.ops import cuda_morph as TM
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_thin import (
    pack_words, unpack_words)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.morphology import (
    binary_dilate, binary_erode, binary_opening)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    adversarial_masks)
from torch_card import card, stages  # noqa: F401  (fixtures)

torch.set_num_threads(1)

DENSITIES = (0.05, 0.3, 0.55, 0.8, 0.95, 1.0)


def _random(h, w):
    g = np.random.default_rng(1000 * h + w)
    return torch.from_numpy(np.stack([g.random((h, w)) < d
                                      for d in DENSITIES]))


def _adversarial(h, w):
    return torch.from_numpy(np.stack(list(adversarial_masks(h, w).values())))


def _opening(m):
    return binary_opening(m, 3, shape="ellipse")


MASKS = ([pytest.param(_random, hw, id=f"random-{hw[0]}x{hw[1]}")
          for hw in ((1, 1), (2, 2), (5, 37), (7, 130), (33, 70), (320, 256))]
         + [pytest.param(_adversarial, hw, id=f"adversarial-{hw[0]}x{hw[1]}")
            for hw in ((320, 256), (33, 70), (7, 130))])


@pytest.mark.parametrize("make,hw", MASKS)
def test_reconstruction_is_the_identity(make, hw):
    """open -> erode marker -> reconstruction returns the opening."""
    m = make(*hw)
    assert torch.equal(TM.open_erode_reconstruct_plain(m), _opening(m))


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 12), w=st.integers(1, 70),
       density=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 32 - 1))
def test_reconstruction_is_the_identity_on_any_small_mask(h, w, density,
                                                           seed):
    m = torch.from_numpy(np.random.default_rng(seed).random((2, h, w))
                         < density)
    assert torch.equal(TM.open_erode_reconstruct_plain(m), _opening(m))


@pytest.mark.parametrize("make,hw", MASKS)
def test_word_algebra_matches_the_twin(make, hw):
    m = make(*hw)
    got = TM.open_cross_words_plain(m)
    assert got.dtype == torch.bool and got.shape == m.shape
    assert torch.equal(got, TM.open_erode_reconstruct_plain(m))


@pytest.mark.parametrize("rows,words", [(1, 1), (3, 2), (5, 1), (32, 32)])
@pytest.mark.parametrize("hw", [(33, 70), (7, 130), (131, 195)])
def test_word_algebra_on_bands_and_strips_smaller_than_the_frame(hw, rows,
                                                                  words):
    """Bands and strips that cut the frame anywhere: halo rows and halo
    words carry the neighbours across every cut."""
    m = _random(*hw)
    assert torch.equal(TM.open_cross_words_plain(m, rows, words), _opening(m))


@pytest.mark.parametrize("w", [1, 31, 33, 70, 130])
def test_word_algebra_ignores_padding_bits(w):
    """Planes whose padding bits (beyond the row's end in its last word) are
    set give the same words, and none of those bits in the output."""
    m = _random(9, w)
    planes = pack_words(m)
    pad = torch.zeros_like(planes)
    pad[..., -1] = ~((1 << (w % 32)) - 1) if w % 32 else 0
    assert bool(((planes & pad) == 0).all())
    clean = TM._open_cross_words(planes, w)
    dirty = TM._open_cross_words(planes | pad, w)
    assert torch.equal(dirty, clean)
    assert bool(((dirty & pad) == 0).all())
    assert torch.equal(unpack_words(dirty, w), _opening(m))


# --- kernel G on the card, against its twin ----------------------------------

def _reconstruct_sweeps(mask):
    """(sweeps per image, whether the fixpoint is the opening): the
    synchronous 8-connected dilations of the marker inside the opening that
    change anything, as the JAX kernel's fixpoint loop takes them. The
    argument in ``csrc/morph.cu`` says 1 for every image with an opening
    that the marker misses somewhere, else 0, and the fixpoint the
    opening."""
    opened = _opening(mask)
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


@pytest.mark.card
def test_kernel_g_equals_its_twin_on_the_main_paths_mask(stages):
    """The path's cleaned mask: the kernel equals the twin and the path's
    own binary mask (F -> B -> G composed by hand), and the twin's
    reconstruction there changes at most one sweep an image and ends at the
    opening (the identity, seen on the card)."""
    got = TM.open_erode_reconstruct_cuda(stages.cleaned)
    assert torch.equal(got, TM.open_erode_reconstruct_plain(stages.cleaned))
    assert torch.equal(got, stages.res.binary)
    sweeps, fixpoint_is_opening = _reconstruct_sweeps(stages.cleaned)
    assert int(sweeps.max()) <= 1 and fixpoint_is_opening


GPU_CASES = ([f"random({d}) (8, 320, 256)" for d in (0.3, 0.55, 0.8, 0.95, 1.0)]
             + ["adversarial (6, 320, 256)"]
             + [f"ragged (4, {h}, {w})" for h, w in (
                 (1, 1), (5, 37), (7, 130), (33, 70), (131, 195), (40, 2100))]
             + ["tiled stage masks + random(0.8) (16, 512, 512)",
                "tiled stage masks + random(0.8) (4, 1024, 1024)"])


def _gpu_case(case, cleaned):
    """The (B, H, W) mask of ``case`` on ``cleaned``'s device: random masks
    at five densities, the six adversarial masks, ragged frames (half at
    0.55, half at 0.8) from 1x1 to one wider than a strip, and the main
    path's masks tiled into 512x512 and 1024x1024 frames beside a random
    one."""
    g = np.random.default_rng(8)
    dev = cleaned.device
    rnd = lambda d, *s: torch.from_numpy(g.random(s) < d).to(dev)
    shape = tuple(int(v) for v in case[case.rindex("(") + 1:-1].split(", "))
    if case.startswith("random"):
        return rnd(float(case[7:case.index(")")]), *shape)
    if case.startswith("adversarial"):
        return _adversarial(*shape[1:]).to(dev)
    if case.startswith("ragged"):
        return torch.cat([rnd(0.55, 2, *shape[1:]), rnd(0.8, 2, *shape[1:])])
    nb, side = shape[0], shape[1]
    hs, ws = cleaned.shape[-2:]
    quilt = cleaned[:16].reshape(4, 4, hs, ws).permute(0, 2, 1, 3).reshape(
        4 * hs, 4 * ws)
    return torch.stack([quilt.roll((37 * i, 53 * i), (0, 1))[:side, :side]
                        for i in range(nb - 1)] + [rnd(0.8, side, side)])


@pytest.mark.card
@pytest.mark.parametrize("case", GPU_CASES)
def test_kernel_g_equals_its_twin_and_the_word_algebra(stages, case):
    m = _gpu_case(case, stages.cleaned)
    got = TM.open_erode_reconstruct_cuda(m)
    assert torch.equal(got, TM.open_erode_reconstruct_plain(m))
    assert torch.equal(got, TM.open_cross_words_plain(m))


@pytest.mark.card
@pytest.mark.parametrize("hw", [(32, 32), (48, 64), (64, 64), (40, 24)])
def test_kernel_g_on_small_dense_frames(card, hw):
    m = (torch.rand((8, *hw), generator=torch.Generator().manual_seed(0))
         < 0.8).to(card)
    assert torch.equal(TM.open_erode_reconstruct_cuda(m),
                       TM.open_erode_reconstruct_plain(m))


@pytest.mark.card
def test_kernel_g_is_one_device_operation_a_call(stages):
    """The wrapper issues the kernel's one launch and nothing else (no
    fill, no copy): ten calls in one profiled window, since a window has
    been seen to come back one device operation short."""
    from cudabench.tracing import profiled
    calls = 10
    with profiled(stages.cleaned.device, []) as prof:
        for _ in range(calls):
            TM.open_erode_reconstruct_cuda(stages.cleaned)
    assert round(len(prof.ops_within(*prof.window)) / calls) == 1
