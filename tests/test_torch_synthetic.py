"""The port's synthetic inputs against their originals: ``make_batch``
against the root ``bench.py``'s, ``blob_prints`` against the blob generator
of ``tests/test_end_to_end_eer.py`` (copied here as ``_print``, since that
module needs cv2 to import), ``users_gallery`` against
``benchmarks/bench_matching.synth_users_gallery``. All must be equal to the
last bit: the card's smoke run and the JAX benchmarks are compared on
these inputs."""

import numpy as np
import pytest

import bench
from benchmarks.bench_matching import synth_users_gallery
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints, make_batch, users_gallery)


def _print(seed, phase=0.0, h=320, w=256):
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.sqrt(((yy - h / 2) / 1.1) ** 2 + (xx - w / 2) ** 2)
    ang = np.arctan2(yy - h / 2, xx - w / 2)
    ridges = 0.5 + 0.5 * np.cos(r / 4.5 + 2.0 * np.sin(3 * ang) + phase)
    blobs = np.zeros((h, w), np.float32)
    for _ in range(110):
        by, bx = g.integers(40, h - 40), g.integers(40, w - 40)
        rr = g.integers(2, 6)
        blobs[by - rr:by + rr, bx - rr:bx + rr] = 1.0
    ell = (((yy - h / 2) / (0.42 * h)) ** 2 + ((xx - w / 2) / (0.40 * w)) ** 2) < 1
    img = np.where(ell, 1.0 - 0.8 * ridges * (1 - 0.9 * blobs), 0.95)
    return (np.clip(img + g.normal(0, 0.02, (h, w)), 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("batch, shape", [(2, (320, 256)), (5, (64, 48))])
def test_make_batch_equals_bench(batch, shape):
    ours = make_batch(batch, *shape)
    assert ours.dtype == np.float32 and ours.shape == (batch, *shape)
    np.testing.assert_array_equal(ours, bench.make_batch(batch, *shape))


def test_make_batch_prefix_is_stable():
    """One generator seeds the whole batch, so a smaller batch is a prefix."""
    np.testing.assert_array_equal(make_batch(3)[:2], bench.make_batch(2))


@pytest.mark.parametrize("seed, phase", [(3, 0.0), (11, 0.06)])
def test_blob_prints_equal_the_eer_generator(seed, phase):
    ours = blob_prints([seed, seed + 1], [phase, 0.0])
    ref = np.stack([_print(seed, phase), _print(seed + 1, 0.0)])
    np.testing.assert_array_equal(ours, ref.astype(np.float32) / 255.0)
    assert np.array_equal(np.round(ours * 255.0), ref)


@pytest.mark.parametrize("n_min", [40, 12])
def test_users_gallery_equals_bench_matching(n_min):
    ours = users_gallery(4, 3, n_min=n_min)
    ref = synth_users_gallery(4, 3, n_min=n_min)
    assert set(ours) == set(ref._fields)
    for field in ref._fields:
        want = np.asarray(getattr(ref, field))
        assert ours[field].dtype == want.dtype
        assert ours[field].shape == want.shape == (12, 64) + want.shape[2:]
        np.testing.assert_array_equal(ours[field], want)


@pytest.mark.parametrize("fam", range(8))
def test_family_generator_equals_ssl_at_scale(fam):
    """``family_params`` and ``family_render`` against
    ``benchmarks/ssl_at_scale.py``'s: the same generator calls give the
    same parameters and the same uint8 impressions, one family each."""
    from benchmarks import ssl_at_scale as ref
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        N_FAMILIES, family_params, family_render)
    assert N_FAMILIES == ref.N_FAMILIES
    a, b = np.random.default_rng(fam), np.random.default_rng(fam)
    pa, pb = family_params(a, fam), ref.family_params(b, fam)
    assert pa == pb
    for _ in range(2):
        np.testing.assert_array_equal(family_render(a, pa), ref.render(b, pb))
