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
    cc_filter)

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
