"""Port parity for the binarize stage after CLAHE: the port's
``ops.cuda_binarize`` / ``ops.cuda_morph`` functions and the split-filter
entry points of ``ops.cuda_cc`` (on the CPU, the kernels' plain twins)
against the JAX package's Pallas kernels in interpret mode, on inputs made
from a numpy seed.

Tolerances are the JAX package's own (``tests/test_pallas_kernels.py``,
``tests/test_pallas_cc.py``): the fused binarize agrees on more than 99% of
pixels and Sauvola alone on more than 99.9% (the TPU kernels sum the 25x25
box as a log tree and take the patch std as e2 - e1^2, so a pixel on the
`x < threshold` edge can flip, and a flipped pixel can move a component
across a size limit); the mask-only functions are exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from multimodal_biometric_fingerprints_palms_tpu.ops import (
    pallas_bitpack as JB, pallas_cc as JC, pallas_kernels as JK)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
    cuda_binarize as TB, cuda_cc as TC, cuda_morph as TM)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.components import (
    clean_mask)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.morphology import (
    binary_erode, binary_opening, binary_reconstruction_by_dilation)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ridge_image():
    """The (1, 64, 128) ridge-like image on the u8 grid of
    tests/test_pallas_kernels.py's fused-binarize test."""
    g = np.random.default_rng(42)
    yy, xx = np.mgrid[0:64, 0:128].astype(np.float32)
    img = 0.5 + 0.4 * np.cos(np.hypot(yy - 30, xx - 60) / 3.0)
    img += g.normal(0, 0.05, img.shape)
    img = np.round(np.clip(img, 0, 1) * 255) / 255
    return img.astype(np.float32)[None]


def _binarize_after_clahe_unfused(img_eq):
    """The stage as the port composed it before it had kernel F and G:
    front -> clean 80/150 -> open -> erode marker -> reconstruction."""
    binary = TB.binarize_foreground_plain(img_eq, 25, 0.25, 32)
    cleaned = clean_mask(binary, 80, 150, connectivity=1)
    opened = binary_opening(cleaned, 3, shape="ellipse")
    marker = binary_erode(opened, 3, shape="ellipse")
    return binary_reconstruction_by_dilation(marker, opened)


@pytest.mark.parametrize("name", ["binarize_fused_split", "binarize_fused"])
def test_binarize_fused_matches_pallas(ridge_image, name):
    ref = np.asarray(getattr(JK, name + "_pallas")(
        jnp.asarray(ridge_image), interpret=True))
    x = torch.from_numpy(ridge_image)
    got = getattr(TB, name)(x)
    assert got.dtype == torch.bool and ref.dtype == np.bool_
    agree = (got.numpy() == ref).mean()
    assert agree > 0.99, agree
    assert 0.2 < got.float().mean() < 0.8          # not a trivial mask
    assert torch.equal(got, _binarize_after_clahe_unfused(x))


def test_sauvola_binarize_matches_pallas():
    x = np.random.default_rng(42).random((2, 64, 128)).astype(np.float32)
    ref = np.asarray(JK.sauvola_binarize_pallas(jnp.asarray(x), interpret=True))
    got = TB.sauvola_binarize(torch.from_numpy(x))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    assert (got.numpy() == ref).mean() > 0.999


def _masks(kind):
    g = np.random.default_rng(7)
    h, w = 32, 64
    yy, xx = np.mgrid[:h, :w]
    ridge = np.cos(np.sqrt((yy - 16.0) ** 2 + (xx - 32.0) ** 2) / 2.5) > 0.0
    if kind == "ridges":
        return np.stack([ridge, ~ridge, ridge & (g.random((h, w)) > 0.1)])
    return np.stack([g.random((h, w)) > 0.3, g.random((h, w)) > 0.15,
                     np.zeros((h, w), bool), np.ones((h, w), bool)])


@pytest.mark.parametrize("kind", ["ridges", "noise"])
def test_open_erode_reconstruct_matches_pallas(kind):
    m = _masks(kind)
    ref = np.asarray(JB.open_erode_reconstruct_packed(jnp.asarray(m),
                                                      interpret=True))
    got = TM.open_erode_reconstruct(torch.from_numpy(m))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["ridges", "noise", "ragged"])
def test_pallas_tail_is_the_cross_opening(kind):
    """The JAX kernel's marker and reconstruction change nothing: its output
    is the 3x3-cross opening, the one pass kernel G takes."""
    m = (np.random.default_rng(8).random((3, 33, 70)) < 0.7
         if kind == "ragged" else _masks(kind))
    ref = np.asarray(JB.open_erode_reconstruct_packed(jnp.asarray(m),
                                                      interpret=True))
    opened = binary_opening(torch.from_numpy(m), 3, shape="ellipse")
    np.testing.assert_array_equal(ref, opened.numpy())
    np.testing.assert_array_equal(
        TM.open_cross_words_plain(torch.from_numpy(m)).numpy(), ref)
    assert ref.any()


def _split_batch():
    """The batch of tests/test_pallas_cc.py's split tests: noise, ridges, a
    speck at the centre beside a big off-centre component, empty, full."""
    g = np.random.default_rng(42)
    h, w = 32, 64
    yy, xx = np.mgrid[:h, :w]
    ridge = np.cos(np.sqrt((yy - 16.0) ** 2 + (xx - 32.0) ** 2) / 2.5) > 0.0
    speck = np.zeros((h, w), bool)
    speck[15:17, 32] = True
    speck[2:20, 2:8] = True
    return np.stack([g.random((h, w)) > 0.5, ridge, speck,
                     np.zeros((h, w), bool), np.ones((h, w), bool)])


@pytest.mark.parametrize("conn", [1, 2])
def test_remove_small_split_matches_pallas(conn):
    m = _split_batch()
    ref = np.asarray(JC.remove_small_split_pallas(
        jnp.asarray(m), 10, connectivity=conn, interpret=True))
    got = TC.remove_small_split(torch.from_numpy(m), 10, connectivity=conn)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("conn", [1, 2])
def test_fill_holes_split_matches_pallas(conn):
    """The JAX kernel is handed the border-connected background as packed
    planes; the port's entry point needs no such input."""
    m = _split_batch()
    reach1 = JB.border_reach_packed(jnp.asarray(~m), connectivity=conn,
                                    interpret=True, packed=True, union=False)
    ref = np.asarray(JC.fill_holes_split_pallas(
        jnp.asarray(m), reach1, 25, connectivity=conn, interpret=True))
    got = TC.fill_holes_split(torch.from_numpy(m), 25, connectivity=conn)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy() != m).any()                # some hole was filled


def test_fill_holes_phase2_is_the_4_connected_hole_fill():
    m = torch.from_numpy(_split_batch())
    assert torch.equal(TB.fill_holes_phase2(m, 25),
                       TC.cc_filter(m, "fill_holes", 1, max_size=25))


# --- the identities kernel F's two launches rest on -------------------------
#
# Launch 1 forms tap * element once per element and adds the products in tap
# order, vertical pass first; launch 2 takes the Otsu prefix sums eight bins
# a lane plus a scan over the lanes. Both must give the twin's bits.

def _frames(kind, shape):
    g = np.random.default_rng(sum(shape))
    x = g.random(shape, dtype=np.float32)
    if kind == "u8":
        x = (np.round(x * 255) / 255).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["random", "u8"])
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 33, 70), (2, 7, 130)])
@pytest.mark.parametrize("win", [25, 33])
def test_premultiplied_box_filter_is_bit_equal(win, shape, kind):
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.filters import (
        box_filter)
    x = _frames(kind, shape)
    mean, std = TB.box_mean_std_passes_plain(x, win)
    ref = box_filter(x, win)
    sq = box_filter(x * x, win)
    assert torch.equal(mean, ref)
    assert torch.equal(std, torch.sqrt(torch.clamp(sq - ref * ref, min=0.0)))
    assert float(std.max()) > 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otsu_prefix_sums_are_order_free(seed):
    """omega and mu sum multiples of 1/1024 below 256: any order of the
    additions gives the same float32 bits."""
    g = np.random.default_rng(seed)
    counts = np.bincount(g.integers(0, 256, 1024) // (1 + 3 * seed),
                         minlength=256).astype(np.float32)
    p = torch.from_numpy(counts) / 1024.0
    bins = torch.arange(256, dtype=torch.float32)
    perm = torch.from_numpy(g.permutation(256))
    for terms in (p, p * bins):
        serial = torch.zeros(())
        for t in terms:
            serial = serial + t
        shuffled = torch.zeros(())
        for t in terms[perm]:
            shuffled = shuffled + t
        tree = terms.clone()
        while tree.numel() > 1:
            tree = tree[0::2] + tree[1::2]
        assert serial == shuffled == tree[0] == torch.cumsum(terms, 0)[-1]
        # every prefix, taken backwards from the total, is exact too
        back = serial - torch.cumsum(terms.flip(0), 0).flip(0) + terms
        assert torch.equal(back, torch.cumsum(terms, 0))


@pytest.mark.parametrize("kind", ["random", "u8", "ridges"])
def test_otsu_patch_passes_match_the_twin(ridge_image, kind):
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_kernels import (
        bin_to_unit)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.histogram import (
        otsu_threshold_patchwise)
    x = (torch.from_numpy(ridge_image) if kind == "ridges"
         else _frames(kind, (3, 64, 96)))
    arg, p_std = TB.otsu_patch_passes_plain(x)
    thr = otsu_threshold_patchwise(x, 32)[..., ::32, ::32]
    assert torch.equal(bin_to_unit(arg), thr)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    blocks = x.reshape(lead + (h // 32, 32, w // 32, 32))
    centred = blocks - blocks.mean(dim=(-3, -1), keepdim=True)
    ref = torch.sqrt((centred * centred).mean(dim=(-3, -1)))
    # another order of 1,024 additions: a few ulps, and the same gate
    assert float((p_std - ref).abs().max()) <= 1e-6
    assert torch.equal(p_std >= 3.0 / 255.0, ref >= 3.0 / 255.0)
