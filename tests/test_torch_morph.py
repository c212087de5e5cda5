"""Kernel G's function on the CPU (``ops.cuda_morph``): the binarize tail's
reconstruction is the identity, so the tail is the 3x3-cross opening; and
the kernel's word algebra (``open_cross_words_plain``: bands, halos, funnel
shifts, padding bits) equals the plain twin. All exact, on masks made from a
numpy seed, ragged widths included. (The JAX package's Pallas kernel is held
to the opening in ``tests/test_torch_binarize.py``.)"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from multimodal_biometric_fingerprints_palms_tpu_torch.ops import cuda_morph as TM
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_thin import (
    pack_words, unpack_words)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.morphology import (
    binary_opening)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    adversarial_masks)

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
