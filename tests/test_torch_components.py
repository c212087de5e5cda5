"""Port parity: connected components (kernel B's plain twin) and the mask
ops built on it, against the JAX package on the CPU. All outputs are
boolean or integer labels and must match exactly."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from multimodal_biometric_fingerprints_palms_tpu.ops import components as J
from multimodal_biometric_fingerprints_palms_tpu.ops import morphology as JM
from multimodal_biometric_fingerprints_palms_tpu.ops.pallas_cc import (
    cc_filter_pallas, clean_mask_split)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import components as T
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import morphology as TM
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_cc import (
    BACKGROUND, cc_filter, cc_filter_plain, cc_label_plain)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    adversarial_masks)

torch.set_num_threads(1)


def _masks(seed, b, h, w, density=0.55):
    return np.random.default_rng(seed).random((b, h, w)) < density


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("conn", [1, 2])
def test_connected_components_labels_exact(conn):
    m = _masks(0, 3, 48, 40)
    lab = T.connected_components(torch.from_numpy(m), conn)
    assert lab.dtype == torch.int32
    _eq(J.connected_components(jnp.asarray(m), conn), lab)
    _eq(J.component_sizes(J.connected_components(jnp.asarray(m), conn),
                          jnp.asarray(m)),
        T.component_sizes(lab, torch.from_numpy(m)))


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       shape=st.sampled_from([(32, 32), (64, 64)]),
       density=st.sampled_from([0.35, 0.5, 0.65]),
       conn=st.sampled_from([1, 2]))
def test_cc_filters_exact_random(seed, shape, density, conn):
    m = _masks(seed, 2, *shape, density)
    mj, mt = jnp.asarray(m), torch.from_numpy(m)
    _eq(J.connected_components(mj, conn), T.connected_components(mt, conn))
    _eq(J.remove_small_objects(mj, 7, conn), T.remove_small_objects(mt, 7, conn))
    _eq(J.remove_small_holes(mj, 9, conn), T.remove_small_holes(mt, 9, conn))
    _eq(J.clean_mask(mj, 7, 9, conn), T.clean_mask(mt, 7, 9, conn))
    _eq(J.largest_component(mj, conn), T.largest_component(mt, conn))


def test_largest_component_tie_goes_to_smallest_label():
    m = np.zeros((2, 16, 16), bool)
    m[0, 8:11, 8:11] = True            # two 9-px squares: the upper one
    m[0, 2:5, 12:15] = True            # has the smaller label and wins
    m[1, 1:3, 1:3] = True              # 4 px, smaller label
    m[1, 10:12, 10:12] = True          # 4 px
    out = T.largest_component(torch.from_numpy(m))
    _eq(J.largest_component(jnp.asarray(m)), out)
    assert out[0, 2, 12] and not out[0, 8, 8]
    assert out[1, 1, 1] and not out[1, 10, 10]


@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruction_by_dilation_exact(seed):
    mask = _masks(seed, 2, 56, 64, 0.6)
    marker = np.random.default_rng(seed + 7).random(mask.shape) < 0.01
    ref = JM.binary_reconstruction_by_dilation(
        jnp.asarray(marker), jnp.asarray(mask), max_iters=4096)
    _eq(ref, TM.binary_reconstruction_by_dilation(torch.from_numpy(marker),
                                                  torch.from_numpy(mask)))


def test_cc_filter_matches_pallas_interpret():
    """The path's two CC uses against the TPU kernels in interpret mode:
    the 4-connected clean and the 8-connected largest component."""
    m = _masks(3, 2, 64, 64)
    mj, mt = jnp.asarray(m), torch.from_numpy(m)
    _eq(cc_filter_pallas(mj, "clean", 1, min_size=10, max_size=20,
                         interpret=True),
        cc_filter(mt, "clean", 1, min_size=10, max_size=20))
    _eq(clean_mask_split(mj, 10, 20, connectivity=1, interpret=True),
        T.clean_mask(mt, 10, 20, connectivity=1))
    _eq(cc_filter_pallas(mj, "largest", 2, interpret=True),
        cc_filter(mt, "largest", 2))


def test_convex_hull_and_bbox_exact():
    m = np.zeros((3, 64, 48), bool)
    m[0, 10:40, 5:30] = True
    m[0, 45, 40] = True
    rr, cc = np.mgrid[0:64, 0:48]
    m[1] = (rr - 30) ** 2 / 300 + (cc - 20) ** 2 / 150 < 1
    m[1, 5:8, 30:44] = True
    mj, mt = jnp.asarray(m), torch.from_numpy(m)
    _eq(J.convex_hull_mask(mj, 90), T.convex_hull_mask(mt, 90))
    _eq(J.mask_bbox(mj), T.mask_bbox(mt))


ADVERSARIAL = ("spiral", "serpentine", "checkerboard", "comb", "full", "empty")


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_plain_twin_exact_on_adversarial_masks(name, conn):
    """The masks on which the card's smoke run holds kernel B to its plain
    twin (components that cross every tile seam, the most runs a row holds,
    the trivial planes), at a small size that is no multiple of the kernel's
    tile: here the twin itself is held to the JAX package, labels and every
    filter mode."""
    h, w = 37, 45
    m = adversarial_masks(h, w)[name][None]
    marker = np.random.default_rng(11).random(m.shape) < 0.02
    mj, mt = jnp.asarray(m), torch.from_numpy(m)
    lab = cc_label_plain(mt, conn)
    _eq(J.connected_components(mj, conn), lab)
    _eq(J.remove_small_objects(mj, 40, conn),
        cc_filter_plain(mt, "remove_small", conn, min_size=40))
    _eq(J.remove_small_holes(mj, 40, conn),
        cc_filter_plain(mt, "fill_holes", conn, max_size=40))
    _eq(J.clean_mask(mj, 40, 40, conn),
        cc_filter_plain(mt, "clean", conn, min_size=40, max_size=40))
    _eq(J.largest_component(mj, conn),
        cc_filter_plain(mt, "largest", conn))
    if conn == 2:       # the JAX reconstruction dilates with a 3x3 square
        _eq(JM.binary_reconstruction_by_dilation(
            jnp.asarray(marker & m), mj, max_iters=4096),
            cc_filter_plain(mt, "reach", conn,
                            marker=torch.from_numpy(marker)))


def test_adversarial_masks_are_what_they_claim():
    masks = adversarial_masks(37, 45)
    assert tuple(masks) == ADVERSARIAL

    def one(m, conn):
        lab = cc_label_plain(torch.from_numpy(m[None]), conn)
        return int(torch.unique(lab[lab != BACKGROUND]).numel())

    for name in ("spiral", "serpentine", "comb", "full"):
        assert one(masks[name], 1) == 1, name          # one component
    assert one(masks["checkerboard"], 2) == 1
    assert one(masks["checkerboard"], 1) == int(masks["checkerboard"].sum())
    assert not masks["empty"].any()
    # the spiral is one pixel wide: no 2x2 block is set
    s = masks["spiral"]
    assert not (s[:-1, :-1] & s[1:, :-1] & s[:-1, 1:] & s[1:, 1:]).any()
