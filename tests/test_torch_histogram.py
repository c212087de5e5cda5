"""Port parity: ops/histogram.py (percentiles, Otsu, CLAHE = kernel A's
plain twin) against the JAX package on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bench import make_batch
from multimodal_biometric_fingerprints_palms_tpu.ops import histogram as J
from multimodal_biometric_fingerprints_palms_tpu.ops.pallas_kernels import (
    clahe_pallas)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import histogram as T
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_kernels import (
    clahe_lut_plain, clahe_lut_scan_plain)

torch.set_num_threads(1)

# CLAHE: the LUTs agree exactly (all their sums are exact in float32 at
# these tile sizes); the blend may differ by one float32 rounding, and a
# LUT may differ by one level only at a cdf*scale half-integer tie.
CLAHE_ATOL = 1.0 / 255.0 + 1e-6
CLAHE_MAX_OFF = 1e-3       # fraction of pixels further apart than 1e-6


def _u8_images(rng, b, h, w):
    return (rng.integers(0, 256, (b, h, w)) / 255.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def bench_pair():
    return make_batch(2)


def test_percentile_stretch_exact(rng, bench_pair):
    for x in (bench_pair, rng.random((3, 64, 48), dtype=np.float32)):
        np.testing.assert_array_equal(
            np.asarray(J.percentile_stretch(jnp.asarray(x), 0.5, 99.5)),
            T.percentile_stretch(_t(x), 0.5, 99.5).numpy())


def test_quantiles_bisect_exact(rng):
    x = rng.random((2, 40, 56), dtype=np.float32)
    np.testing.assert_array_equal(
        np.asarray(J.quantiles_bisect(jnp.asarray(x), jnp.asarray([2.0, 50.0, 98.0]))),
        T.quantiles_bisect(_t(x), [2.0, 50.0, 98.0]).numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_histogram256_exact(rng, weighted):
    v = rng.integers(0, 256, (3, 500)).astype(np.int32)
    wt = (rng.random((3, 500)) < 0.5) if weighted else None
    j = J.histogram256(jnp.asarray(v), None if wt is None else jnp.asarray(wt))
    t = T.histogram256(_t(v), None if wt is None else _t(wt))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_otsu_exact(rng, bench_pair):
    for x in (bench_pair, _u8_images(rng, 3, 64, 64)):
        np.testing.assert_array_equal(np.asarray(J.otsu_threshold(jnp.asarray(x))),
                                      T.otsu_threshold(_t(x)).numpy())
        np.testing.assert_array_equal(
            np.asarray(J.otsu_threshold_patchwise(jnp.asarray(x), 32)),
            T.otsu_threshold_patchwise(_t(x), 32).numpy())


def _jax_lut(x, clip_limit, grid):
    """The LUT lines of the JAX package's XLA CLAHE (histogram.py:313-326)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    th, tw = h // grid, w // grid
    v = J._to_u8(jnp.asarray(x))
    tiles = jnp.swapaxes(v.reshape(lead + (grid, th, grid, tw)), -3, -2)
    hist = J.histogram256(tiles.reshape(lead + (grid, grid, th * tw)))
    limit = max(float(int(clip_limit * th * tw / 256)), 1.0)
    excess = jnp.sum(jnp.maximum(hist - limit, 0.0), axis=-1, keepdims=True)
    cdf = jnp.cumsum(jnp.minimum(hist, limit) + excess / 256, axis=-1)
    return np.asarray(jnp.clip(jnp.round(cdf * (255.0 / (th * tw))), 0, 255))


def _assert_clahe_close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.max() <= CLAHE_ATOL, d.max()
    assert (d > 1e-6).mean() <= CLAHE_MAX_OFF, (d > 1e-6).mean()


@pytest.mark.parametrize("shape", [(2, 320, 256), (3, 64, 64)])
@pytest.mark.parametrize("clip", [2.0, 2.5])
def test_clahe_matches_xla(rng, bench_pair, shape, clip):
    if shape[1:] == (320, 256):
        x = np.round(np.clip(bench_pair, 0, 1) * 255) / 255
    else:
        x = _u8_images(rng, *shape)
    x = x.astype(np.float32)
    lut_j = _jax_lut(x, clip, 8)
    lut_t = clahe_lut_plain(_t(x), clip, 8).numpy()
    assert np.abs(lut_j - lut_t).max() <= 1.0
    assert (lut_j != lut_t).mean() <= 1e-3
    _assert_clahe_close(J.clahe(jnp.asarray(x), clip, 8), T.clahe(_t(x), clip, 8))


def test_clahe_matches_pallas_interpret(rng):
    x = _u8_images(rng, 1, 64, 64)
    ref = clahe_pallas(jnp.asarray(x), 2.5, 8, interpret=True)
    _assert_clahe_close(ref, T.clahe(_t(x), 2.5, 8))


# --- the identities kernel A's pass 1 rests on -------------------------------
#
# A thread a bin: the excess summed as a tree, the CDF as a scan. The excess
# sums integer-valued floats and the CDF multiples of 2^-8 up to the tile's
# area, exact in float32 in any order up to an area of 65,536; the LUT's
# values are integers 0..255, so bytes hold them.

def _skewed(rng, b, h, w):
    """u8-grid images with most pixels in a few bins: a large excess."""
    v = np.where(rng.random((b, h, w)) < 0.7, rng.integers(100, 104, (b, h, w)),
                 rng.integers(0, 256, (b, h, w)))
    return (v / 255.0).astype(np.float32)


@pytest.mark.parametrize("shape,grid", [((3, 64, 64), 8), ((2, 320, 256), 8),
                                        ((2, 72, 40), 8), ((1, 512, 512), 2),
                                        ((3, 8, 8), 8)])
@pytest.mark.parametrize("clip", [2.0, 2.5, 40.0])
def test_clahe_lut_in_scan_order_is_bit_equal(rng, shape, grid, clip):
    for x in (_u8_images(rng, *shape), _skewed(rng, *shape),
              rng.random(shape, dtype=np.float32)):
        lut = clahe_lut_plain(_t(x), clip, grid)
        assert torch.equal(lut, lut.to(torch.uint8).float())    # bytes hold it
        scan = clahe_lut_scan_plain(_t(x), clip, grid)
        assert scan.dtype == torch.uint8 and scan.shape == lut.shape
        assert torch.equal(scan.float(), lut)
    assert (512 // 2) ** 2 == 65536       # the largest order-free tile area


# --- true divisions ---------------------------------------------------------
#
# PyTorch on CUDA turns `tensor / python_scalar` into a multiplication by a
# reciprocal, one ulp off a true division for divisors that are no power of
# two, so the port divides by tensors. On the CPU both forms divide truly;
# these tests pin the values to numpy's true division and the source to the
# tensor form.

def _np_u8_grid(x):
    return (np.clip(np.rint(x * np.float32(255)), 0, 255).astype(np.float32)
            / np.float32(255))


def _np_quantiles(xq, qs):
    """np.percentile('linear') in float32, from sorted order statistics."""
    flat = np.sort(xq.reshape(xq.shape[0], -1), axis=-1)
    v = (np.float32(flat.shape[-1] - 1) * np.asarray(qs, np.float32)
         / np.float32(100))
    k0, k1 = np.floor(v), np.ceil(v)
    lo, hi = flat[:, k0.astype(int)], flat[:, k1.astype(int)]
    return lo + (v - k0) * (hi - lo)


@pytest.mark.parametrize("qs", [[0.5, 99.5], [2.0, 37.0, 50.0, 98.0]])
def test_quantiles_u8_equal_numpy_true_division(rng, bench_pair, qs):
    for x in (bench_pair, rng.random((3, 64, 48), dtype=np.float32)):
        want = _np_quantiles(_np_u8_grid(x), qs)
        got = T.quantiles_u8(_t(x), qs).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_percentile_stretch_equals_numpy_true_division(rng, bench_pair):
    for x in (bench_pair, rng.random((3, 64, 48), dtype=np.float32)):
        xq = _np_u8_grid(x)
        q = _np_quantiles(xq, [0.5, 99.5])
        lo, hi = q[:, 0, None, None], q[:, 1, None, None]
        want = np.clip((xq - lo) / np.maximum(hi - lo, np.float32(1e-8)),
                       0, 1).astype(np.float32)
        got = T.percentile_stretch(_t(x), 0.5, 99.5).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("module", ["ops/histogram.py", "features/quality.py"])
def test_no_division_by_a_python_scalar_that_is_no_power_of_two(module):
    from pathlib import Path
    src = (Path(T.__file__).resolve().parent.parent / module).read_text()
    for form in ("/ 255.0", "/ 100.0", "/ (w / 2.0)", "/ (h / 2.0)", "/ 255)",
                 "/ 100)"):
        assert form not in src, form
