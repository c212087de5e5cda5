"""The port's SSL augmentations against the JAX package's:

- ``classifier/augment_device.py``: each image's 13 draws (``split(fold_in(
  rng, i), 13)``: uniforms, the randint, the flips) bit-equal to
  ``jax.random``'s; the noise's random bits, drawn on tensors, bit-equal;
  its normals within 1e-5 relative (``torch.erfinv`` against XLA's;
  measured 4.8e-6, times sigma 0.015 in a view); the angle's cosine and
  sine within 1 ulp; views within 1e-5 of ``augment_batch`` run op by op
  (measured 3.0e-7), and within 1e-4 of it jitted, as the JAX trainer runs
  it: XLA then fuses the coordinate arithmetic into multiply-adds, which
  moves the JAX function's own views by up to 6.4e-5 at 320 x 240 ->
  224 (a coordinate's last place times a neighbour difference);
- ``classifier/data.py``: ``FingerprintAugmentations`` and
  ``two_view_batches`` bit-equal to the JAX package's (OpenCV) for the
  same ``np.random.Generator``, on frames whose width is and is not a
  multiple of 16 (OpenCV's warp forms its coordinates one way in its
  vector loop and another in the scalar tail: ``utils/cvcompat.py``).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu.classifier import (
    augment_device as JA, data as JD)
from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (
    augment_device as TA, data as TD)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
    cvcompat, threefry)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints)

torch.set_num_threads(1)


def _keys(seed):
    """The same step key on both sides: ``fold_in(split(key(seed))[1], 0)``."""
    jr = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed))[1], 0)
    tr = threefry.fold_in(threefry.split(threefry.key(seed))[1], 0)
    assert tuple(int(v) for v in jax.random.key_data(jr)) == tr
    return jr, tr


def _jax_draws(jr, n, h, w, size):
    out = []
    for i in range(n):
        k = jax.random.split(jax.random.fold_in(jr, i), 13)
        u = lambda j, lo=0.0, hi=1.0: np.float32(
            jax.random.uniform(k[j], (), minval=lo, maxval=hi))
        ninety = 90.0 * jax.random.randint(k[2], (), 0, 4)
        theta = jnp.deg2rad(jnp.where(u(1) < 0.8, u(0, -15.0, 15.0), ninety))
        scale = u(5, 0.8, 1.0)
        crop = scale * min(h, w)
        out.append(dict(
            theta=np.float32(theta), cos=np.float32(jnp.cos(theta)),
            sin=np.float32(jnp.sin(theta)), flip_lr=u(3) < 0.5,
            flip_ud=u(4) < 0.3, crop=np.float32(crop),
            ox=np.float32(u(6) * (w - crop)), oy=np.float32(u(7) * (h - crop)),
            step=np.float32(crop / float(size)), do_bc=u(8) < 0.5,
            alpha=u(9, 0.8, 1.2), beta=u(10, -0.1, 0.1),
            do_noise=u(11) < 0.5,
            noise_key=tuple(int(v) for v in jax.random.key_data(k[12]))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_draws_equal_jax_random(seed):
    """16 images: every scalar draw bit-equal; cosine and sine within an
    ulp."""
    jr, tr = _keys(seed)
    want = _jax_draws(jr, 16, 320, 240, 224)
    got = TA.draws(tr, 16, 320, 240, 224)
    for i, w in enumerate(want):
        for name in ("theta", "flip_lr", "flip_ud", "crop", "ox", "oy",
                     "step", "do_bc", "alpha", "beta", "do_noise"):
            assert got[name][i] == w[name], (i, name)
        assert tuple(int(v) for v in got["noise_keys"][i]) == w["noise_key"]
        np.testing.assert_array_max_ulp(got["cos"][i], w["cos"], maxulp=1)
        np.testing.assert_array_max_ulp(got["sin"][i], w["sin"], maxulp=1)


def test_noise_bits_on_tensors_equal_jax_random():
    """The device stream: ``random_bits_tensor`` equals ``jax.random.bits``
    for 3 keys x 50,176 elements (one 224 x 224 view each); its normals
    within 1e-5 of ``jax.random.normal``."""
    keys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(3)]
    tkeys = [tuple(int(v) for v in jax.random.key_data(k)) for k in keys]
    bits = threefry.random_bits_tensor(tkeys, 224 * 224, "cpu").numpy()
    normal = threefry.normal_tensor(tkeys, (224, 224), "cpu").numpy()
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(
            bits[i], np.asarray(jax.random.bits(k, (224 * 224,))).astype(np.int64))
        np.testing.assert_allclose(normal[i], np.asarray(
            jax.random.normal(k, (224, 224))), rtol=1e-5, atol=1e-6)


def test_batched_keys_equal_jax_random_key_by_key():
    """One threefry serves the host and the device: ``fold_in`` of an
    array, then ``split``, ``random_bits``, ``uniform_from``, ``randint``
    and ``bernoulli`` over a (6, 2) batch of keys equal ``jax.random``'s
    key by key; a tensor of the same keys draws the same bits and mask."""
    jr = jax.random.PRNGKey(7)
    jkeys = [jax.random.fold_in(jr, i) for i in range(6)]
    words = lambda k: [int(v) for v in jax.random.key_data(k)]
    keys = threefry.fold_in(threefry.key(7), np.arange(6))
    assert keys.tolist() == [words(k) for k in jkeys]
    assert threefry.split(keys, 3).tolist() == [
        [words(c) for c in jax.random.split(k, 3)] for k in jkeys]
    bits = threefry.random_bits(keys, (5, 7))
    uni = threefry.uniform_from(keys, (9,), -2.0, 3.0)
    ints = threefry.randint(keys, (4,), -3, 1000)
    mask = threefry.bernoulli(keys, 0.9, (33,))
    for i, k in enumerate(jkeys):
        np.testing.assert_array_equal(bits[i], np.asarray(
            jax.random.bits(k, (5, 7))))
        np.testing.assert_array_equal(uni[i], np.asarray(
            jax.random.uniform(k, (9,), minval=-2.0, maxval=3.0)))
        np.testing.assert_array_equal(ints[i], np.asarray(
            jax.random.randint(k, (4,), -3, 1000)))
        np.testing.assert_array_equal(mask[i], np.asarray(
            jax.random.bernoulli(k, 0.9, (33,))))
    on_tensor = torch.from_numpy(keys)
    assert torch.equal(threefry.random_bits(on_tensor, (5, 7)),
                       torch.from_numpy(bits.astype(np.int64)))
    assert torch.equal(threefry.bernoulli(on_tensor, 0.9, (33,)),
                       torch.from_numpy(mask))


@pytest.fixture(scope="module")
def jax_augment():
    return jax.jit(JA.augment_batch, static_argnums=2)


@pytest.mark.parametrize("shape,size", [((6, 40, 30), 24), ((2, 320, 240), 224)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_views_match_jax(jax_augment, shape, size, seed):
    x = np.random.default_rng(seed).random(shape, np.float32)
    jr, tr = _keys(seed)
    eager = np.asarray(JA.augment_batch(jnp.asarray(x), jr, size))
    jitted = np.asarray(jax_augment(jnp.asarray(x), jr, size))
    got = TA.augment_batch(torch.from_numpy(x), tr, size).numpy()
    assert got.shape == eager.shape
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-4)


def _print_u8(h, w, seed=11):
    return np.round(blob_prints([seed], None, h, w)[0] * 255.0).astype(np.uint8)


@pytest.mark.parametrize("shape", [(320, 240), (80, 60), (37, 29)])
def test_fingerprint_augmentations_bit_equal(shape):
    """40 views each from the same generator seeds (rotations of both
    kinds, flips, crops of integer and fractional ratios, jitter and noise
    all drawn); a blob print at 320 x 240, random bytes below."""
    img = (_print_u8(*shape) if shape[0] >= 120 else np.random.default_rng(
        shape[1]).integers(0, 256, shape, dtype=np.uint8))
    for s in range(40):
        want = JD.FingerprintAugmentations(32, np.random.default_rng(s))(img)
        got = TD.FingerprintAugmentations(32, np.random.default_rng(s))(img)
        np.testing.assert_array_equal(got, want)


def test_two_view_batches_bit_equal(tmp_path):
    """Seven OpenCV-written JPEGs (the port decodes them through its codec)
    and an unreadable file, batch 3: the same batches, the last one
    dropped, the bad file skipped in both."""
    paths = []
    for k in range(7):
        p = tmp_path / f"{k + 1}_1_1.jpg"
        cv2.imwrite(str(p), _print_u8(120, 100, 20 + k))
        paths.append(p)
    (tmp_path / "9_1_1.jpg").write_bytes(b"not an image")
    paths.append(tmp_path / "9_1_1.jpg")
    want = list(JD.two_view_batches(paths, 3, 32, seed=7))
    got = list(TD.two_view_batches(paths, 3, 32, seed=7))
    assert len(got) == len(want) == 2
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("w", [60, 61, 30, 72, 17])
def test_warp_scalar_tail_bit_equal(w):
    """OpenCV's warp beyond the last multiple of 16 columns, 1 and 3
    channels."""
    g = np.random.default_rng(w)
    for img in (g.random((50, w), np.float32), g.random((50, w, 3), np.float32)):
        for angle in (-13.3, 4.0, 11.9):
            m = cv2.getRotationMatrix2D((w // 2, 25), angle, 1.0)
            np.testing.assert_array_equal(
                cvcompat.warp_affine_linear(img, m, (w, 50)),
                cv2.warpAffine(img, m, (w, 50), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REFLECT_101))
