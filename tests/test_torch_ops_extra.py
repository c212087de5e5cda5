"""Port parity of the ops that lie off the enhance path: geometry (point
rotation, angle wrapping, the antialiased bilinear resize, the affine
warp), global histogram equalization, greyscale morphology
and reconstruction, the bilateral filter, the config dump and the float
native loader, against the JAX package on the CPU at small, ragged sizes."""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from multimodal_biometric_fingerprints_palms_tpu.config import loader as JL
from multimodal_biometric_fingerprints_palms_tpu.ops import (
    denoise as JD, geometry as JG, histogram as JH, morphology as JM)
from multimodal_biometric_fingerprints_palms_tpu.utils import (
    native_loader as JN)
from multimodal_biometric_fingerprints_palms_tpu_torch.config import (
    loader as TL)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
    denoise as TD, geometry as TG, histogram as TH, morphology as TM)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
    image_codec, native_loader as TN)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints)

torch.set_num_threads(1)

# Float tolerances. Rotation, the wrap and the warp's bilinear blend are
# the same float32 operations, but XLA may fuse a product and a sum into one
# rounding where PyTorch rounds twice, and the 2x2 inverse and the (HW, 2)
# product are LAPACK / BLAS calls of either framework: a few ulp of values
# up to a few hundred. The resize contracts with the same float32 weights in
# another summation order. The bilateral filter's exp is either framework's.
ROTATE_ATOL = 1e-4            # coordinates up to ~100 px
ANGLE_ATOL = 1e-6
RESIZE_ATOL = 1e-6            # values in [0, 1]
WARP_ATOL = 1e-4              # values in [0, 1]; weights from ~300 px coords
BILATERAL_ATOL = 1e-6


def _img(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(a, b, atol):
    d = np.abs(np.asarray(a, np.float64) - b.numpy().astype(np.float64))
    assert d.max() <= atol, d.max()


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


# --- geometry -----------------------------------------------------------------

def test_rotate_points():
    g = np.random.default_rng(0)
    pts = g.uniform(-100, 100, (3, 17, 2)).astype(np.float32)
    theta = g.uniform(-math.pi, math.pi, (3,)).astype(np.float32)
    _close(JG.rotate_points(jnp.asarray(pts), jnp.asarray(theta)),
           TG.rotate_points(torch.from_numpy(pts), torch.from_numpy(theta)),
           ROTATE_ATOL)
    # one angle for every point set, as a Python float
    _close(JG.rotate_points(jnp.asarray(pts), 0.3),
           TG.rotate_points(torch.from_numpy(pts), 0.3), ROTATE_ATOL)


@pytest.mark.parametrize("fn", ["angle_diff", "orientation_diff"])
def test_angle_wrapping(fn):
    g = np.random.default_rng(1)
    a = g.uniform(-10, 10, (500,)).astype(np.float32)
    b = g.uniform(-10, 10, (500,)).astype(np.float32)
    a[:4] = b[:4] + np.float32([math.pi, -math.pi, math.pi / 2, 0.0])
    ref = getattr(JG, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(TG, fn)(torch.from_numpy(a), torch.from_numpy(b))
    _close(ref, got, ANGLE_ATOL)


@pytest.mark.parametrize("shape", [(64, 80), (20, 23), (64, 23), (37, 50),
                                   (111, 9)])
def test_resize_bilinear_up_and_down(shape):
    """Up-scaling, down-scaling (where jax.image.resize antialiases), one
    axis each way, and an axis left as it is."""
    x = _img(2, 2, 37, 50)
    ref = JG.resize_bilinear(jnp.asarray(x), shape)
    got = TG.resize_bilinear(torch.from_numpy(x), shape)
    assert tuple(got.shape) == (2,) + shape
    _close(ref, got, RESIZE_ATOL)


def test_resize_bilinear_is_not_interpolate_when_shrinking():
    """A halving averages a triangle of four pixels a side, not two."""
    x = _img(3, 1, 64, 64)
    got = TG.resize_bilinear(torch.from_numpy(x), (16, 16))
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x)[None], size=(16, 16), mode="bilinear",
        align_corners=False)[0]
    assert float((got - plain).abs().max()) > 1e-2


@pytest.mark.parametrize("angle,shift,fill", [(7.0, (3.5, -2.25), 0.0),
                                              (-11.0, (-9.0, 6.0), 0.95),
                                              (0.0, (0.0, 0.0), 0.0)])
def test_affine_warp(angle, shift, fill):
    """A float64 rotation about the centre plus a shift (the second-session
    warp of the Gabor protocol), sampled bilinearly, filled outside."""
    x = _img(4, 61, 47)
    h, w = x.shape
    t = math.radians(angle)
    cx, cy = w / 2, h / 2
    m = np.array([[math.cos(t), math.sin(t), 0.0],
                  [-math.sin(t), math.cos(t), 0.0]])
    m[:, 2] = (cx - m[0, 0] * cx - m[0, 1] * cy + shift[0],
               cy - m[1, 0] * cx - m[1, 1] * cy + shift[1])
    ref = JG.affine_warp(jnp.asarray(x), jnp.asarray(m), fill)
    got = TG.affine_warp(torch.from_numpy(x), m, fill)
    _close(ref, got, WARP_ATOL)


# --- histogram ---------------------------------------------------------------------

def test_equalize_hist_exact():
    x = _img(6, 2, 37, 50) ** 2
    _same(JH.equalize_hist(jnp.asarray(x)),
          TH.equalize_hist(torch.from_numpy(x)))


# --- greyscale morphology ------------------------------------------------------

@pytest.mark.parametrize("op", ["dilate", "erode", "opening", "closing"])
@pytest.mark.parametrize("size,shape", [(3, "rect"), (4, "rect"), (5, "rect"),
                                        (3, "ellipse"), (4, "ellipse"),
                                        (7, "ellipse")])
def test_greyscale_morphology_exact(op, size, shape):
    """Min and max only, on a ragged frame; even sizes pin the two padding
    alignments (the rect form's SAME window, the ellipse's centre)."""
    x = _img(7, 2, 29, 37)
    _same(getattr(JM, op)(jnp.asarray(x), size, shape),
          getattr(TM, op)(torch.from_numpy(x), size, shape))


@pytest.mark.parametrize("max_iters", [1, 3, 256])
def test_reconstruction_by_dilation_exact(max_iters):
    """To the fixpoint (256) and cut short by ``max_iters``."""
    x = _img(8, 2, 31, 45)
    marker = np.array(JM.erode(jnp.asarray(x), 7))
    _same(JM.reconstruction_by_dilation(jnp.asarray(marker), jnp.asarray(x),
                                        max_iters),
          TM.reconstruction_by_dilation(torch.from_numpy(marker),
                                        torch.from_numpy(x), max_iters))


# --- the bilateral filter --------------------------------------------------------

@pytest.mark.parametrize("d,sc,ss", [(5, 50.0, 7.0), (7, 20.0, 3.0)])
def test_bilateral_filter(d, sc, ss):
    """numpy's "reflect" border (the port's "mirror"), on a print-like image
    and on noise."""
    x = np.concatenate([blob_prints([3], None, 96, 96)[:, 30:70, 20:56],
                        _img(9, 1, 40, 36)])
    _close(JD.bilateral_filter(jnp.asarray(x), d, sc, ss),
           TD.bilateral_filter(torch.from_numpy(x), d, sc, ss),
           BILATERAL_ATOL)


# --- config, native loader ----------------------------------------------------------

@pytest.mark.parametrize("name", ["fingerprint", "matching", "classifier",
                                  "segmentation"])
def test_print_config_summary_same_stdout(name, capsys):
    getattr_ = f"load_{name}_config"
    JL.print_config_summary(getattr(JL, getattr_)(), title=name)
    ref = capsys.readouterr().out
    TL.print_config_summary(getattr(TL, getattr_)(), title=name)
    assert capsys.readouterr().out == ref
    assert ref.count("\n") > 5


def test_batch_load_equals_jax_binding(tmp_path):
    """The float loader over the same native library: the JAX binding's
    output wherever the library builds (it needs libjpeg)."""
    if not TN.native_available():
        pytest.skip("native loader unavailable: no libjpeg or g++ here")
    img = np.round(blob_prints([4], None, 96, 96)[0, 20:60, 16:72] * 255
                   ).astype(np.uint8)
    paths = []
    for i, ext in enumerate((".jpg", ".bmp")):
        p = tmp_path / f"{i}{ext}"
        p.write_bytes(image_codec.encode_for(p, img))
        paths.append(p)
    paths.append(tmp_path / "missing.jpg")
    ref = JN.batch_load(paths, 64, 64, 2)
    got = TN.batch_load(paths, 64, 64, 2)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].tolist() == [0, 0, 1]


@pytest.mark.parametrize("module", [JN, TN])
def test_batch_load_raises_without_the_library(module, monkeypatch):
    monkeypatch.setattr(module, "_get_lib", lambda: None)
    for fn in (module.batch_load, module.batch_load_u8):
        with pytest.raises(RuntimeError, match="native loader unavailable"):
            fn(["x.jpg"], 8, 8)
