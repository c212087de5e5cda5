"""Port parity of the Gabor stage (``ops/gabor.py`` and the ``gabor=True``
branch of ``preprocess_fingerprint``) against the JAX package on the CPU:
the kernel bank bit for bit, the frequency estimates, the two enhancers,
the branch's image handed to binarize, the chain from there given the JAX
stage's inputs, and the whole chain on two ``make_batch`` images; then the
file runners on the Gabor EER protocol's prints (``utils.synthetic``'s
copies of ``benchmarks/gabor_eer.py``'s generator).

The JAX chain runs once per module, in its XLA form (``use_pallas=False``),
as ``tests/test_torch_enhance.py`` runs it.
"""

import importlib.util
import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bench import make_batch
import multimodal_biometric_fingerprints_palms_tpu.preprocessing.enhance as J
import multimodal_biometric_fingerprints_palms_tpu.features as JF
from multimodal_biometric_fingerprints_palms_tpu.ops import (
    gabor as JG, orientation as JO)
import multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.enhance as T
import multimodal_biometric_fingerprints_palms_tpu_torch.features as TF
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import gabor as TG
from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
    runner as tprun)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import synthetic

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# configs/config_fingerprint.yml's preprocessing.gabor, without ``enabled``
GABOR_PARAMS = dict(n_orientations=12, n_frequencies=4, block_size=32,
                    kernel_size=11)
# The bank: the same taps in the same order as the JAX conv2d_same (the
# responses come out bit-equal); the branch's [0, 1] map divides and clips
# the same float32 values.
ENHANCE_ATOL = 1e-5
# Frequencies. The spectra are two FFT libraries' (ulp apart, 3e-6 of the
# largest magnitude measured). Where a block's in-band maximum is unique
# the bins agree exactly; a block whose maximum is tied (a masked block
# that is a near-delta has a flat spectrum: measured, 3 of 160 blocks of
# these two images, all below the fallback threshold) may land on another
# tied bin in either package. The fallback mean weights every block's peak
# by its frequency, so such a flip moves it by the flipped block's weight
# times the bin change over the weight sum: measured 2.6e-05 here. Away
# from ties the values agree to FREQ_ATOL.
FREQ_ATOL = 1e-6
TIE_RTOL = 1e-6
# End to end. Given the JAX stage's inputs the branch and everything after
# it match exactly (test_chain_after_the_branch_is_exact). The port's
# segmented image differs from the JAX one as in tests/test_torch_enhance.py
# (NLM's sums in another order; 2 hull pixels of 82,043 move). The branch
# divides each image by its largest response, which sits at the hull's
# edge: in image 0 the two moved pixels take the maximum from 11.061 to
# 10.611, so the whole image's [0, 1] map scales by 4% and binarize flips
# 574 of its pixels (the JAX package's own XLA and Pallas denoise routes
# move no hull pixel, and their Gabor skeletons differ in 8 of 4,545
# pixels). Measured: 312 of 4,545 skeleton pixels (6.9%), valid minutiae
# equal. Against the existing 5%, the Gabor chain is held to 10% of the JAX
# skeleton's pixels and the existing 2 minutiae per image.
E2E_SKEL_MISMATCH = 0.10
E2E_COUNT_DIFF = 2
# The runners on the protocol's prints are held to tests/test_torch_runners.py's
# end-to-end bounds (measured: 287 of 14,621 skeleton pixels, 2.0%).
RUNNER_SKEL_MISMATCH = 0.05


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_stages():
    """The JAX chain on two bench images up to the orientation field, and
    its Gabor branch, binarize and thin stages from there."""
    x = make_batch(2)
    n = J.normalize_image(jnp.asarray(x))
    d = J.denoise_image(n, use_pallas=False)
    s, m = J.segment_fingerprint(d)
    f = JO.compute_orientation_field(s, mask=m)
    fm = JG.estimate_ridge_frequency_blockwise(s, mask=m, block_size=32)
    resp = JG.gabor_enhance_blockfreq(s, f.orientation, fm, mask=m,
                                      n_orientations=12, n_frequencies=4,
                                      size=11)
    amp = jnp.max(jnp.abs(resp), axis=(-2, -1), keepdims=True)
    tb = jnp.where(m, jnp.clip(0.5 + 0.5 * resp / jnp.maximum(amp, 1e-6),
                               0.0, 1.0), s)
    b = J.binarize(tb, use_pallas=False)
    sm = J.smooth_fingerprint_skeleton(b.astype(jnp.float32))
    sk = J.thinning_and_cleaning(sm, f.reliability, use_pallas=False)
    ms = JF.postprocess_minutiae(JF.extract_minutiae(sk), sk)
    return dict(x=x, segmented=s, mask=m, orientation=f.orientation,
                reliability=f.reliability, freq_map=fm, resp=resp,
                to_binarize=tb, binary=b, skeleton=sk, minutiae=ms)


def _close(a, b, atol):
    d = np.abs(np.asarray(a, np.float64) - b.numpy().astype(np.float64))
    assert d.max() <= atol, d.max()


@pytest.mark.parametrize("theta,freq,size,sigma", [
    (0.0, 1 / 9, 11, 4.0), (-np.pi / 2, 1 / 16, 11, 4.0),
    (np.pi / 7, 0.25, 11, 4.0), (1.2, 0.099, 15, 3.0), (-0.4, 1 / 9, 7, 2.5)])
def test_gabor_kernel_bit_equal(theta, freq, size, sigma):
    ref = JG.gabor_kernel(theta, freq, sigma, sigma, size)
    got = TG.gabor_kernel(theta, freq, sigma, sigma, size)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_block_frequency_map(jax_stages):
    s, m = jax_stages["segmented"], jax_stages["mask"]
    ref = np.asarray(jax_stages["freq_map"])
    got = TG.estimate_ridge_frequency_blockwise(_t(s), mask=_t(m)).numpy()
    assert got.shape == ref.shape == (2, 10, 8)
    # the blocks' own peaks, both packages' way, before the fallback
    b = 32
    xj = np.where(np.asarray(m), np.asarray(s), 0).reshape(2, 10, b, 8, b)
    blocks = xj.swapaxes(-3, -2)
    blocks = blocks - blocks.mean(axis=(-2, -1), keepdims=True)
    spec = np.abs(np.fft.rfft2(blocks.astype(np.float64)))
    fy = np.fft.fftfreq(b)[:, None]
    fx = np.fft.rfftfreq(b)[None, :]
    fr = np.sqrt(fy * fy + fx * fx).astype(np.float32)
    band = (fr >= 1 / 16) & (fr <= 1 / 4)
    flat = np.where(band, spec, 0).reshape(2, 10, 8, -1)
    # blocks whose maximum ties across bins of different frequency
    ties = np.zeros(flat.shape[:-1], bool)
    top = flat.max(axis=-1, keepdims=True)
    near = flat >= top * (1 - TIE_RTOL)
    frs = fr.reshape(-1)
    for idx in np.ndindex(*flat.shape[:-1]):
        ties[idx] = len(set(frs[near[idx]].tolist())) > 1
    # above the fallback threshold the map is the block's own bin: exact
    peak = flat.max(axis=-1)
    own = peak > 0.1 * peak.max(axis=(-2, -1), keepdims=True) * (1 + 1e-5)
    np.testing.assert_array_equal(got[own & ~ties], ref[own & ~ties])
    # each image's fallback value: one value, within FREQ_ATOL unless a
    # tied block's bin moved the weighted mean
    for i in range(2):
        fb = ~own[i]
        assert len(set(got[i][fb].tolist())) <= 1
        if fb.any():
            atol = FREQ_ATOL if not ties[i].any() else 3e-5
            assert abs(got[i][fb][0] - ref[i][fb][0]) <= atol
    print(f"tied blocks {int(ties.sum())} of {ties.size}, max |d| "
          f"{np.abs(got - ref).max():.3g}")


def test_global_frequency(jax_stages):
    s, m, o = (jax_stages[k] for k in ("segmented", "mask", "orientation"))
    ref = np.asarray(JG.estimate_ridge_frequency(s, o, mask=m))
    got = TG.estimate_ridge_frequency(_t(s), _t(o), mask=_t(m)).numpy()
    np.testing.assert_array_equal(got, ref)
    # an odd frame and no mask: fftfreq and rfftfreq of odd lengths
    x = np.random.default_rng(2).random((2, 45, 39), dtype=np.float32)
    np.testing.assert_array_equal(
        TG.estimate_ridge_frequency(torch.from_numpy(x), None).numpy(),
        np.asarray(JG.estimate_ridge_frequency(jnp.asarray(x), None)))


def test_gabor_enhance_blockfreq(jax_stages):
    s, m, o = (jax_stages[k] for k in ("segmented", "mask", "orientation"))
    got = TG.gabor_enhance_blockfreq(_t(s), _t(o), _t(jax_stages["freq_map"]),
                                     mask=_t(m), n_orientations=12,
                                     n_frequencies=4, size=11)
    _close(jax_stages["resp"], got, ENHANCE_ATOL)


@pytest.mark.parametrize("n_orientations,freq", [(16, 1 / 9), (8, 1 / 6)])
def test_gabor_enhance(jax_stages, n_orientations, freq):
    s, m, o = (jax_stages[k] for k in ("segmented", "mask", "orientation"))
    ref = JG.gabor_enhance(s, o, mask=m, freq=freq,
                           n_orientations=n_orientations)
    got = TG.gabor_enhance(_t(s), _t(o), mask=_t(m), freq=freq,
                           n_orientations=n_orientations)
    _close(ref, got, ENHANCE_ATOL)
    _close(JG.gabor_enhance(s, o, freq=freq, n_orientations=n_orientations),
           TG.gabor_enhance(_t(s), _t(o), freq=freq,
                            n_orientations=n_orientations), ENHANCE_ATOL)


def test_branch_to_binarize(jax_stages):
    """What the gabor=True branch hands to binarize, from the JAX stage
    inputs (``preprocess_fingerprint`` calls ``gabor_stage``)."""
    s, m, o = (_t(jax_stages[k]) for k in ("segmented", "mask", "orientation"))
    _close(jax_stages["to_binarize"],
           T.gabor_stage(s, m, o, dict(GABOR_PARAMS)), ENHANCE_ATOL)


def test_chain_after_the_branch_is_exact(jax_stages):
    """binarize -> smooth -> thin on the JAX branch's image: the port's
    skeleton equals the JAX one."""
    b = T.binarize(_t(jax_stages["to_binarize"]))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jax_stages["binary"]))
    sm = T.smooth_fingerprint_skeleton(b.to(torch.float32))
    sk = T.thinning_and_cleaning(sm, _t(jax_stages["reliability"]))
    np.testing.assert_array_equal(sk.numpy(),
                                  np.asarray(jax_stages["skeleton"]))


def test_whole_chain_with_gabor(jax_stages):
    """Bench images -> minutiae through the port alone with gabor=True (and
    the config's parameters), against the JAX chain end to end."""
    res = T.preprocess_fingerprint(_t(jax_stages["x"]), gabor=True,
                                   gabor_params=dict(GABOR_PARAMS))
    ms = TF.postprocess_minutiae(TF.extract_minutiae(res.skeleton),
                                 res.skeleton)
    sk_j = np.asarray(jax_stages["skeleton"])
    mismatch = int((res.skeleton.numpy() != sk_j).sum())
    print(f"skeleton mismatch {mismatch} of {int(sk_j.sum())}")
    assert mismatch <= E2E_SKEL_MISMATCH * sk_j.sum(), (mismatch, sk_j.sum())
    cnt_j = np.asarray(jax_stages["minutiae"].count)
    assert np.abs(cnt_j - ms.count.numpy()).max() <= E2E_COUNT_DIFF
    # the stage changes the chain's binary input
    plain = T.preprocess_fingerprint(_t(jax_stages["x"]))
    assert bool((plain.binary != res.binary).any())


def test_runner_reads_the_gabor_config(monkeypatch):
    """run_preprocessing(gabor=None), as ``pipeline.run_all`` calls it,
    takes the stage when ``preprocessing.gabor.enabled`` is set, with the
    config's parameters."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.config import (
        loader)
    cfg = loader.load_fingerprint_config().to_dict()
    cfg["preprocessing"]["gabor"]["enabled"] = True
    monkeypatch.setattr(tprun, "load_fingerprint_config",
                        lambda: loader.ConfigNode(cfg))
    assert tprun._gabor_setting(None) == (True, GABOR_PARAMS)
    assert tprun._gabor_setting(False) == (False, None)
    monkeypatch.undo()
    assert tprun._gabor_setting(None) == (False, None)
    assert tprun._gabor_setting(True) == (True, GABOR_PARAMS)


# --- the Gabor EER protocol's generator and the file runners -------------------

def _jax_protocol():
    spec = importlib.util.spec_from_file_location(
        "gabor_eer", ROOT / "benchmarks" / "gabor_eer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_protocol_generator_is_the_scripts_and_deterministic():
    """``protocol_print`` is the JAX script's ``_print`` bit for bit; the
    second session is the same image for the same seed, another for
    another seed, and close to the OpenCV-made one (same random draws)."""
    ref = _jax_protocol()
    for seed, phase in ((11, 0.0), (12, 0.06)):
        np.testing.assert_array_equal(synthetic.protocol_print(seed, phase),
                                      ref._print(seed, phase))
    base = synthetic.protocol_print(11, 0.06)
    a = synthetic.degrade_session(base, 11, 0.35)
    np.testing.assert_array_equal(a, synthetic.degrade_session(base, 11, 0.35))
    assert not np.array_equal(a, synthetic.degrade_session(base, 12, 0.35))
    assert a.dtype == np.uint8 and a.shape == base.shape
    cv = ref._degrade(ref._print(11, 0.06), 11, 0.35)
    assert np.abs(a.astype(np.int64) - cv).mean() < 1.0


PROTOCOL_USERS = (1, 2, 3)


@pytest.fixture(scope="module")
def protocol_trees(tmp_path_factory):
    """3 users x 2 sessions of the protocol (session 2 degraded at severity
    0.35), written once, through the JAX package's preprocessing and
    features runners with gabor=True and through the port's on the CPU."""
    root = tmp_path_factory.mktemp("gabor_protocol")
    cluster = root / "sorted" / "cluster_0"
    cluster.mkdir(parents=True)
    for u in PROTOCOL_USERS:
        cv2.imwrite(str(cluster / f"{u}_1_1.jpg"),
                    synthetic.protocol_print(10 + u))
        cv2.imwrite(str(cluster / f"{u}_1_2.jpg"), synthetic.degrade_session(
            synthetic.protocol_print(10 + u, 0.06), 10 + u, 0.35))
    batch = 2 * len(PROTOCOL_USERS)
    cwd = os.getcwd()
    try:
        os.chdir(root)
        from multimodal_biometric_fingerprints_palms_tpu.features.runner import (
            process_directory as jfeat)
        from multimodal_biometric_fingerprints_palms_tpu.preprocessing.runner import (
            run_preprocessing as jprep)
        from multimodal_biometric_fingerprints_palms_tpu_torch.features.runner import (
            process_directory as tfeat)
        for who, prep, feat, kw in (("jax", jprep, jfeat, {}),
                                    ("port", tprun.run_preprocessing, tfeat,
                                     {"device": "cpu"})):
            prep(root / "sorted", root / who, batch_size=batch, debug=False,
                 gabor=True, **kw)
            feat(root / who / "enhanced", root / who / "minutiae",
                 batch_size=batch, **kw)
    finally:
        os.chdir(cwd)
    return root


def test_protocol_runners_with_gabor(protocol_trees):
    """Skeletons and valid minutiae per image within the runner tests'
    end-to-end bounds (5% of skeleton pixels, 2 minutiae), the same
    files."""
    root = protocol_trees
    jsk = sorted((root / "jax" / "enhanced").rglob("*_skeleton.jpg"))
    assert len(jsk) == 2 * len(PROTOCOL_USERS)
    total = mismatch = 0
    for p in jsk:
        q = root / "port" / p.relative_to(root / "jax")
        a = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE) > 127
        b = cv2.imread(str(q), cv2.IMREAD_GRAYSCALE) > 127
        total += int(a.sum())
        mismatch += int((a != b).sum())
    print(f"skeleton mismatch {mismatch} of {total}")
    assert mismatch <= RUNNER_SKEL_MISMATCH * total
    jm = sorted((root / "jax" / "minutiae").rglob("*_minutiae.json"))
    assert len(jm) == len(jsk)
    for p in jm:
        q = root / "port" / p.relative_to(root / "jax")
        nj = len(json.loads(p.read_text()))
        nt = len(json.loads(q.read_text()))
        assert abs(nj - nt) <= E2E_COUNT_DIFF, (p.name, nj, nt)
