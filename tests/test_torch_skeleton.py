"""Port parity: Zhang-Suen thinning (kernel C's plain twin) and the prune
of isolated pixels, against the JAX package's XLA form and its bit-packed
Pallas kernel (interpret mode) on the CPU. Skeletons must match exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from multimodal_biometric_fingerprints_palms_tpu.ops import skeleton as J
from multimodal_biometric_fingerprints_palms_tpu.ops.pallas_bitpack import (
    zs_thin_bitpacked)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import skeleton as T
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_thin import (
    zs_thin)

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
