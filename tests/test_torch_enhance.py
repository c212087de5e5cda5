"""Port parity for the enhance + extract slice, stage by stage and end to
end, on two ``bench.make_batch`` images at 320x256 on the CPU.

Stage-wise, each port stage gets the JAX stage's own input (the JAX output
of the previous stage), so a float difference upstream cannot move a
threshold downstream. Boolean stages must match exactly; float stages
within the tolerances below. The JAX chain runs in its XLA form
(``use_pallas=False``), as the JAX package's own CPU tests run it, and
once more as its kernel-backed path (``use_pallas=True``), composed by hand
because the enhance functions pass no ``interpret``: the Pallas NLM and
binarize kernels run in interpret mode there.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bench import make_batch
import multimodal_biometric_fingerprints_palms_tpu.preprocessing.enhance as J
import multimodal_biometric_fingerprints_palms_tpu.features as JF
from multimodal_biometric_fingerprints_palms_tpu.ops import (
    orientation as JO, pallas_kernels as JK)
import multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.enhance as T
import multimodal_biometric_fingerprints_palms_tpu_torch.features as TF
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
    orientation as TO)

torch.set_num_threads(1)

# NLM rounds its SSD and weights to bfloat16 at the same points as the JAX
# form, but sums the 7-tap box and the 441 offsets in another order and
# uses another exp; the JAX docstring puts bf16 NLM within ~1.2 gray levels
# of f32, so two bf16 forms stay well inside 2 gray levels.
DENOISE_ATOL = 2.0 / 255.0
# Orientation / reliability: float32 sums in another order (separable
# blurs, block sums, the bilinear upsample); angles compared modulo pi.
ORIENT_ATOL = 1e-4
# End to end, the denoise difference moves a few ridge edges by a pixel
# (measured: 103 of 4,309 skeleton pixels, 2.4%, on these two images), so
# the whole-slice bound is 5% of the JAX skeleton's pixels, and the count
# of valid minutiae per image may move by at most 2 (it matched exactly
# when measured).
E2E_SKEL_MISMATCH = 0.05
E2E_COUNT_DIFF = 2
# The foreground mask moves by a hull-boundary pixel or two (measured: 2 of
# 82,043 mask pixels).
E2E_MASK_MISMATCH = 1e-3


# The kernel-backed JAX path against the port. On random images the
# symmetric-pair NLM kernel equals the port's NLM within 1e-6
# (tests/test_torch_nlm.py); on these CLAHE'd images, whose values sit near
# bf16 rounding boundaries, the two packages' exp land on both sides of
# some, as against the XLA form (measured: 8.9e-4 against either JAX form,
# whose own two forms differ by 8.1e-5), so DENOISE_ATOL holds here too.
# The fused binarize kernels agree with the JAX package's own XLA form,
# which the port equals exactly, on 96.67% of these images' pixels: 5,453 of
# the 5,458 differing pixels lie outside the foreground hull, in four
# patches of the zeroed background with 2-12 occupied histogram bins, where
# Otsu's between-class variance is tied across the empty bins and the
# kernel's matmul prefix sums break the tie another way than cumsum (the
# deviation tests/test_pallas_kernels.py describes for that kernel). So the
# stage is held to > 99.9% inside the hull and > 95% overall.
KERNEL_BINARIZE_AGREE_IN_HULL = 0.999
KERNEL_BINARIZE_AGREE = 0.95


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX package's stages on two bench images, each fed the previous
    stage's output (this is the JAX end-to-end chain)."""
    x = make_batch(2)
    n = J.normalize_image(jnp.asarray(x))
    d = J.denoise_image(n, use_pallas=False)
    s, m = J.segment_fingerprint(d)
    f = JO.compute_orientation_field(s, mask=m)
    b = J.binarize(s, use_pallas=False)
    sm = J.smooth_fingerprint_skeleton(b.astype(jnp.float32))
    sk = J.thinning_and_cleaning(sm, f.reliability, use_pallas=False)
    ms = JF.postprocess_minutiae(JF.extract_minutiae(sk), sk)
    return dict(x=x, normalized=n, denoised=d, segmented=s, mask=m,
                orientation=f.orientation, reliability=f.reliability,
                binary=b, smooth=sm, skeleton=sk, minutiae=ms)


@pytest.fixture(scope="module")
def jax_kernel_chain(jax_chain):
    """The JAX package's ``use_pallas=True`` enhance path on the same two
    images: ``nlm_denoise_pallas_sym`` and ``binarize_fused_split_pallas``
    in interpret mode inside ``denoise_image`` / ``binarize`` as those
    functions compose them; the thin stage in its XLA form (its kernels
    are held in tests/test_torch_components.py and test_torch_skeleton.py)."""
    n = jax_chain["normalized"]
    d = J.gaussian_blur_cv(JK.nlm_denoise_pallas_sym(n, interpret=True),
                           ksize=3, sigma=0.6)
    s, m = J.segment_fingerprint(d)
    f = JO.compute_orientation_field(s, mask=m)
    img_eq = J.clahe(J._quantize_u8(s), clip_limit=2.5, grid=8)
    b = JK.binarize_fused_split_pallas(img_eq, 25, 0.25, interpret=True)
    sm = J.smooth_fingerprint_skeleton(b.astype(jnp.float32))
    sk = J.thinning_and_cleaning(sm, f.reliability, use_pallas=False)
    ms = JF.postprocess_minutiae(JF.extract_minutiae(sk), sk)
    return dict(denoised=d, segmented=s, mask=m, binary=b, skeleton=sk,
                minutiae=ms)


def _close(a, b, atol):
    d = np.abs(np.asarray(a, np.float64) - b.numpy().astype(np.float64))
    assert d.max() <= atol, d.max()


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_normalize(jax_chain):
    # percentile stretch is exact; CLAHE's LUTs are exact here
    _close(jax_chain["normalized"], T.normalize_image(_t(jax_chain["x"])),
           1.0 / 255.0 + 1e-6)


def test_denoise(jax_chain):
    _close(jax_chain["denoised"], T.denoise_image(_t(jax_chain["normalized"])),
           DENOISE_ATOL)


def test_segment(jax_chain):
    seg, mask = T.segment_fingerprint(_t(jax_chain["denoised"]))
    _same(jax_chain["mask"], mask)
    _close(jax_chain["segmented"], seg, 1e-6)


def test_orientation(jax_chain):
    f = TO.compute_orientation_field(_t(jax_chain["segmented"]),
                                     mask=_t(jax_chain["mask"]))
    d = np.abs(np.asarray(jax_chain["orientation"]) - f.orientation.numpy())
    assert np.minimum(d, math.pi - d).max() <= ORIENT_ATOL
    _close(jax_chain["reliability"], f.reliability, ORIENT_ATOL)


def test_binarize(jax_chain):
    _same(jax_chain["binary"], T.binarize(_t(jax_chain["segmented"])))


def test_smooth(jax_chain):
    _same(jax_chain["smooth"], T.smooth_fingerprint_skeleton(
        _t(jax_chain["binary"]).float()))


def test_thin(jax_chain):
    _same(jax_chain["skeleton"], T.thinning_and_cleaning(
        _t(jax_chain["smooth"]), _t(jax_chain["reliability"])))


def test_minutiae_on_jax_skeleton(jax_chain):
    """Given the JAX skeleton, the templates match: positions, types and
    validity exactly; the float fields to float32 rounding of the
    re-estimated orientation field (1e-4 in quality and coherence, 1e-2 rad
    in a minutia's orientation, read off a flat binary image)."""
    sk = _t(jax_chain["skeleton"])
    raw_j = JF.extract_minutiae(jnp.asarray(jax_chain["skeleton"]))
    raw_t = TF.extract_minutiae(sk)
    for f in raw_j._fields:
        _same(getattr(raw_j, f), getattr(raw_t, f))
    ms_j, ms_t = jax_chain["minutiae"], TF.postprocess_minutiae(raw_t, sk)
    for f in ("xy", "minutia_type", "valid"):
        _same(getattr(ms_j, f), getattr(ms_t, f))
    for f, atol in (("quality", 1e-4), ("coherence", 1e-4),
                    ("angular_stability", 1e-2), ("orientation", 1e-2)):
        _close(getattr(ms_j, f), getattr(ms_t, f), atol)


def test_whole_slice(jax_chain):
    """Bench images -> minutiae through the port alone, against the JAX
    chain end to end."""
    res = T.preprocess_fingerprint(_t(jax_chain["x"]))
    ms = TF.postprocess_minutiae(TF.extract_minutiae(res.skeleton),
                                 res.skeleton)
    sk_j = np.asarray(jax_chain["skeleton"])
    mismatch = int((res.skeleton.numpy() != sk_j).sum())
    assert mismatch <= E2E_SKEL_MISMATCH * sk_j.sum(), (mismatch, sk_j.sum())
    mask_j = np.asarray(jax_chain["mask"])
    mask_mismatch = int((res.mask.numpy() != mask_j).sum())
    assert mask_mismatch <= E2E_MASK_MISMATCH * mask_j.sum(), mask_mismatch
    cnt_j = np.asarray(jax_chain["minutiae"].count)
    assert np.abs(cnt_j - ms.count.numpy()).max() <= E2E_COUNT_DIFF
    assert ms.xy.shape == (2, 64, 2) and torch.isfinite(ms.quality).all()


def test_denoise_kernel_path(jax_chain, jax_kernel_chain):
    _close(jax_kernel_chain["denoised"],
           T.denoise_image(_t(jax_chain["normalized"])), DENOISE_ATOL)


def test_binarize_kernel_path(jax_kernel_chain):
    got = T.binarize(_t(jax_kernel_chain["segmented"])).numpy()
    ref = np.asarray(jax_kernel_chain["binary"])
    hull = np.asarray(jax_kernel_chain["mask"])
    assert (got == ref)[hull].mean() > KERNEL_BINARIZE_AGREE_IN_HULL
    assert (got == ref).mean() > KERNEL_BINARIZE_AGREE


def test_whole_slice_kernel_path(jax_chain, jax_kernel_chain):
    """Bench images -> minutiae through the port alone, against the JAX
    package's kernel-backed path end to end."""
    res = T.preprocess_fingerprint(_t(jax_chain["x"]))
    ms = TF.postprocess_minutiae(TF.extract_minutiae(res.skeleton),
                                 res.skeleton)
    sk_j = np.asarray(jax_kernel_chain["skeleton"])
    mismatch = int((res.skeleton.numpy() != sk_j).sum())
    assert mismatch <= E2E_SKEL_MISMATCH * sk_j.sum(), (mismatch, sk_j.sum())
    mask_j = np.asarray(jax_kernel_chain["mask"])
    mask_mismatch = int((res.mask.numpy() != mask_j).sum())
    assert mask_mismatch <= E2E_MASK_MISMATCH * mask_j.sum(), mask_mismatch
    cnt_j = np.asarray(jax_kernel_chain["minutiae"].count)
    assert np.abs(cnt_j - ms.count.numpy()).max() <= E2E_COUNT_DIFF
    print(f"skeleton mismatch {mismatch} of {int(sk_j.sum())}, mask mismatch "
          f"{mask_mismatch}, counts {cnt_j.tolist()} vs {ms.count.tolist()}")


def test_gabor_not_ported():
    """The Gabor stage, once refused here, is ported
    (tests/test_torch_gabor.py holds it to the JAX package): gabor=True
    runs, and its parameters reach the bank (another kernel size, another
    binary image)."""
    x = torch.from_numpy(make_batch(1)[:, :64, :64])
    a = T.preprocess_fingerprint(x, gabor=True)
    b = T.preprocess_fingerprint(x, gabor=True, gabor_params=dict(
        n_orientations=12, n_frequencies=4, block_size=32, kernel_size=7))
    assert a.skeleton.shape == (1, 64, 64)
    assert not torch.equal(a.binary, b.binary)


def test_quality_scores_equal_numpy_true_division():
    """The centre bonus divides by w / 2 and h / 2 (160 at 320 rows: no power
    of two) as tensors; on the CPU the quality scores equal the formula
    evaluated with numpy's true float32 division bit for bit."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        quality as TQ)
    g = np.random.default_rng(21)
    b, k, h, w = 2, 64, 320, 256
    sk = (g.random((b, h, w)) < 0.2).astype(np.float32)
    den, coh = (g.random((b, h, w), dtype=np.float32) for _ in range(2))
    ori = (g.random((b, h, w), dtype=np.float32) - 0.5) * np.float32(np.pi)
    xy = np.stack([g.integers(0, w, (b, k)), g.integers(0, h, (b, k))],
                  axis=-1).astype(np.float32)
    z = torch.zeros((b, k))
    ms = TF.MinutiaeSet(torch.from_numpy(xy), z.to(torch.int32), z, z, z, z,
                        torch.ones((b, k), dtype=torch.bool))
    out = TQ._enrich(ms, *(torch.from_numpy(a) for a in (sk, den, ori, coh)),
                     0.15, 0.2, 30, 15)
    assert int(out.valid.sum()) > 20
    x, y = xy[..., 0].astype(np.int64), xy[..., 1].astype(np.int64)
    rows = np.arange(b)[:, None]
    xf, yf = x.astype(np.float32), y.astype(np.float32)
    bonus = np.float32(1.0) - np.float32(0.5) * (
        (np.abs(xf - np.float32(w / 2.0)) / np.float32(w / 2.0)) ** 2
        + (np.abs(yf - np.float32(h / 2.0)) / np.float32(h / 2.0)) ** 2)
    score = (np.float32(0.5) * out.coherence.numpy()
             + np.float32(0.25) * den[rows, y, x]
             + np.float32(0.1) * out.angular_stability.numpy()
             + np.float32(0.1) * sk[rows, y, x]) * bonus
    want = np.where(out.valid.numpy(), score, np.float32(0)).astype(np.float32)
    np.testing.assert_array_equal(out.quality.numpy().view(np.uint32),
                                  want.view(np.uint32))
