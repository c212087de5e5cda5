"""Port parity: Zhang-Suen thinning (kernel C's plain twin), the prune of
isolated pixels and the spur trim (``prune_endpoints``), against the JAX
package's XLA form and its bit-packed Pallas kernel (interpret mode) on the
CPU; and kernel C's word-parallel algebra in PyTorch against that twin, on
frames of one block and beyond it. Skeletons must match exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from multimodal_biometric_fingerprints_palms_tpu.ops import skeleton as J
from multimodal_biometric_fingerprints_palms_tpu.ops.pallas_bitpack import (
    zs_thin_bitpacked)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import skeleton as T
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_thin import (
    pack_words, unpack_words, zs_thin, zs_thin_plain, zs_thin_words_plain)

torch.set_num_threads(1)


def _ridge_masks(seed, b, h, w):
    """Thick wavy ridges plus speckle: shapes that take several iterations
    to thin and leave isolated pixels to prune."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w), bool)
    for i in range(b):
        phase = g.uniform(0, 6.28)
        ridges = np.cos((yy + 3 * np.sin(xx / 5 + phase)) / 2.2) > -0.1
        out[i] = ridges ^ (g.random((h, w)) < 0.03)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_skeletonize_and_prune_exact(seed):
    m = _ridge_masks(seed, 3, 48, 64)
    sk_j = J.skeletonize(jnp.asarray(m))
    sk_t = T.skeletonize(torch.from_numpy(m))
    np.testing.assert_array_equal(np.asarray(sk_j), sk_t.numpy())
    np.testing.assert_array_equal(np.asarray(J.prune_isolated(sk_j)),
                                  T.prune_isolated(sk_t).numpy())
    np.testing.assert_array_equal(np.asarray(J.neighbor_count(sk_j)),
                                  T.neighbor_count(sk_t).numpy())


def test_thin_matches_bitpacked_interpret():
    m = _ridge_masks(2, 2, 32, 40)
    ref = zs_thin_bitpacked(jnp.asarray(m), prune=True, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(ref), zs_thin(torch.from_numpy(m), 128, prune=True).numpy())


def test_thin_iteration_cap():
    m = _ridge_masks(3, 2, 32, 32)
    for iters in (1, 2):
        np.testing.assert_array_equal(
            np.asarray(J.skeletonize(jnp.asarray(m), max_iters=iters)),
            T.skeletonize(torch.from_numpy(m), max_iters=iters).numpy())


# --- kernel C's word algebra (zs_thin_words_plain) ---------------------------

def _word_masks(h, w):
    """Ridge masks, the trivial planes, the checkerboard and one-pixel
    lines (rows, columns, a diagonal), as one batch."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([*_ridge_masks(4, 2, h, w),
                     np.ones((h, w), bool), np.zeros((h, w), bool),
                     (yy + xx) % 2 == 0,
                     yy % 3 == 0, xx % 3 == 0, yy == xx])


@pytest.mark.parametrize("max_iters", [1, 2, 128])
@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("w", [32, 40, 64, 250])
def test_words_plain_equals_plain(w, prune, max_iters):
    """The bit-sliced subpass on 32-pixel words (kernel C's algebra: adder
    tree, transition count, carries across words and the ragged last word)
    removes exactly the pixels the pixel-per-element twin removes."""
    m = torch.from_numpy(_word_masks(24, w))
    got = zs_thin_words_plain(m, max_iters, prune)
    assert got.dtype == torch.bool and got.shape == m.shape
    np.testing.assert_array_equal(
        got.numpy(), zs_thin_plain(m, max_iters, prune).numpy())


@pytest.mark.parametrize("max_iters", [2, 128])
def test_words_plain_equals_plain_beyond_one_block(max_iters):
    """A frame whose two packed planes exceed one block's shared memory
    (1,000 rows of 33 words: 264,000 bytes), which kernel C thins in device
    memory: the word algebra still removes exactly the twin's pixels, each
    image to its own fixpoint (the empty frame at once)."""
    m = np.concatenate([_ridge_masks(6, 1, 1000, 1030),
                        np.zeros((1, 1000, 1030), bool)])
    m = torch.from_numpy(m)
    np.testing.assert_array_equal(
        zs_thin_words_plain(m, max_iters, True).numpy(),
        zs_thin_plain(m, max_iters, True).numpy())


@pytest.mark.parametrize("iterations", [1, 3])
def test_prune_endpoints_exact(iterations):
    m = _ridge_masks(7, 2, 33, 41)
    sk = J.skeletonize(jnp.asarray(m))
    np.testing.assert_array_equal(
        np.asarray(J.prune_endpoints(sk, iterations)),
        T.prune_endpoints(torch.from_numpy(np.array(sk)), iterations).numpy())


def test_words_plain_matches_bitpacked_interpret():
    m = _ridge_masks(5, 2, 32, 40)
    ref = zs_thin_bitpacked(jnp.asarray(m), prune=True, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(ref),
        zs_thin_words_plain(torch.from_numpy(m), 128, prune=True).numpy())


@pytest.mark.parametrize("w", [1, 31, 32, 33, 70, 250])
def test_pack_unpack_round_trip(w):
    m = torch.from_numpy(np.random.default_rng(w).random((2, 5, w)) < 0.5)
    words = pack_words(m)
    assert words.dtype == torch.int32 and words.shape == (2, 5, -(-w // 32))
    assert torch.equal(unpack_words(words, w), m)
    # bit i of word k is pixel 32k + i; the padding bits are zero
    x = w - 1
    one = torch.zeros((1, w), dtype=torch.bool)
    one[0, x] = True
    expect = np.zeros(-(-w // 32), np.uint32)
    expect[x // 32] = np.uint32(1) << np.uint32(x % 32)
    np.testing.assert_array_equal(
        pack_words(one).numpy().view(np.uint32)[0], expect)
