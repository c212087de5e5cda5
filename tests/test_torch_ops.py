"""Port parity of the plain ops under the slice's kernels: filters,
morphology, NLM and the orientation field, against the JAX package on the
CPU at small sizes."""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from multimodal_biometric_fingerprints_palms_tpu.ops import denoise as JD
from multimodal_biometric_fingerprints_palms_tpu.ops import filters as JFl
from multimodal_biometric_fingerprints_palms_tpu.ops import morphology as JM
from multimodal_biometric_fingerprints_palms_tpu.ops import orientation as JO
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import denoise as TD
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import filters as TFl
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import morphology as TM
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import orientation as TO

torch.set_num_threads(1)

# Filters of <= 5 taps are the same shift-adds in the same order as the JAX
# form (exact); wider ones are banded matmuls there, so the float32 sum
# order differs (a few ulp of values in [0, 1]).
WIDE_ATOL = 1e-6


def _img(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(a, b, atol):
    d = np.abs(np.asarray(a, np.float64) - b.numpy().astype(np.float64))
    assert d.max() <= atol, d.max()


@pytest.mark.parametrize("border", ["reflect", "mirror", "edge", "zero"])
def test_filters(border):
    x = _img(0, 2, 24, 20)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(JFl.gaussian_blur_cv(xj, 5, 0.0, border),
           TFl.gaussian_blur_cv(xt, 5, 0.0, border), 0.0)
    _close(JFl.gaussian_blur(xj, 0.6, border=border),
           TFl.gaussian_blur(xt, 0.6, border=border), 0.0)
    for a, b in zip(JFl.sobel(xj, border), TFl.sobel(xt, border)):
        _close(a, b, 0.0)
    _close(JFl.box_filter(xj, 9, border), TFl.box_filter(xt, 9, border),
           WIDE_ATOL)
    _close(JFl.gaussian_blur(xj, 3.0, border=border),
           TFl.gaussian_blur(xt, 3.0, border=border), WIDE_ATOL)


@pytest.mark.parametrize("size,shape", [(3, "ellipse"), (15, "ellipse"),
                                        (3, "rect")])
def test_binary_morphology_exact(size, shape):
    m = _img(1, 2, 40, 36) < 0.6
    mj, mt = jnp.asarray(m), torch.from_numpy(m)
    np.testing.assert_array_equal(JM.ellipse_se(size), TM.ellipse_se(size))
    for fj, ft in ((JM.binary_dilate, TM.binary_dilate),
                   (JM.binary_erode, TM.binary_erode),
                   (JM.binary_opening, TM.binary_opening),
                   (JM.binary_closing, TM.binary_closing)):
        np.testing.assert_array_equal(np.asarray(fj(mj, size, shape)),
                                      ft(mt, size, shape).numpy())


def test_close_open_matches_packed():
    m = _img(2, 3, 64, 48) < 0.5
    np.testing.assert_array_equal(
        np.asarray(JM.binary_close_open_packed(jnp.asarray(m), 15)),
        TM.binary_close_open_packed(torch.from_numpy(m), 15).numpy())


@pytest.mark.parametrize("precision,atol", [("bf16", 2.0 / 255.0),
                                            ("f32", 1e-5)])
def test_nlm(precision, atol):
    x = _img(3, 2, 32, 40)
    _close(JD.nlm_denoise(jnp.asarray(x), precision=precision),
           TD.nlm_denoise(torch.from_numpy(x), precision=precision), atol)


def test_orientation_field():
    yy, xx = np.mgrid[0:64, 0:48].astype(np.float32)
    x = (0.5 + 0.5 * np.cos((xx + 0.3 * yy) / 2.5)
         + 0.05 * _img(4, 64, 48)).astype(np.float32)[None]
    x = np.round(np.clip(x, 0, 1) * 255) / 255
    m = np.ones_like(x, dtype=bool)
    fj = JO.compute_orientation_field(jnp.asarray(x), mask=jnp.asarray(m))
    ft = TO.compute_orientation_field(torch.from_numpy(x),
                                      mask=torch.from_numpy(m))
    d = np.abs(np.asarray(fj.orientation) - ft.orientation.numpy())
    assert np.minimum(d, math.pi - d).max() <= 1e-4
    _close(fj.reliability, ft.reliability, 1e-4)
    np.testing.assert_array_equal(np.asarray(fj.block_valid),
                                  ft.block_valid.numpy())
