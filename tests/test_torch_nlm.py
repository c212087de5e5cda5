"""Port parity for non-local means: the port's ``nlm_denoise`` (on the CPU,
the plain twin of kernel E) against the JAX package's NLM kernels in
interpret mode, on inputs made from a numpy seed.

Tolerance: 1e-6 absolute, the bound ``tests/test_pallas_kernels.py`` holds
those kernels to against the XLA form. Every per-offset weight and value is
the same rounded number in both packages; the symmetric-pair kernel adds
its direct and mirror terms in another order than the offset order the port
uses, which moves the float32 sums by a few 1e-7.

Marked ``card``: kernel E against the plain twin on the card, within
``NLM_ATOL``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from multimodal_biometric_fingerprints_palms_tpu.ops import (
    pallas_kernels as JK)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
    denoise as TD)
from torch_card import (  # noqa: F401  (card, stages: fixtures)
    NLM_ATOL, NLM_MAX_OFF, card, stages)

torch.set_num_threads(1)

ATOL = 1e-6


def _image(shape):
    return np.random.default_rng(42).random(shape).astype(np.float32)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 16, 32), (2, 40, 128)],
                         ids=["small-frame", "interior+ring"])
def test_nlm_matches_symmetric_pair_kernel(shape, precision):
    x = _image(shape)
    ref = np.asarray(JK.nlm_denoise_pallas_sym(
        jnp.asarray(x), precision=precision, interpret=True))
    got = TD.nlm_denoise(torch.from_numpy(x), precision=precision).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_nlm_matches_blocked_kernel(precision):
    x = _image((1, 16, 32))
    ref = np.asarray(JK.nlm_denoise_pallas_blocked(
        jnp.asarray(x), precision=precision, interpret=True))
    got = TD.nlm_denoise(torch.from_numpy(x), precision=precision).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("entry", ["nlm_denoise_sym", "nlm_denoise_blocked"])
def test_kernel_entry_points_are_the_one_function(entry):
    """The port keeps the JAX package's two kernel entry points; both are
    ``nlm_denoise`` (same parameters but ``interpret``, same result)."""
    import inspect
    jfn = getattr(JK, entry.replace("nlm_denoise_", "nlm_denoise_pallas_"))
    tfn = getattr(TD, entry)
    jp = [(p.name, p.default) for p in inspect.signature(jfn).parameters.values()
          if p.name != "interpret"]
    tp = [(p.name, p.default) for p in inspect.signature(tfn).parameters.values()]
    assert jp == tp
    x = torch.from_numpy(_image((1, 12, 20)))
    for precision in ("bf16", "f32"):
        assert torch.equal(tfn(x, 12.0, 5, 9, precision),
                           TD.nlm_denoise_plain(x, 12.0, 5, 9, precision))


# --- kernel E on the card, against its twin ----------------------------------

def _kernel_against_twin(img, precision):
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops import cuda_nlm
    a = cuda_nlm.nlm_denoise_cuda(img, precision=precision)
    d = (a - TD.nlm_denoise_plain(img, precision=precision)).abs()
    assert bool(torch.isfinite(a).all())
    assert float(d.max()) <= NLM_ATOL
    return d


@pytest.mark.card
@pytest.mark.parametrize("precision,images", [("bf16", 128), ("f32", 16)])
def test_kernel_e_equals_its_twin_on_the_main_paths_input(stages, precision,
                                                          images):
    """The path's normalized images: within NLM_ATOL, and off by more than
    1e-6 on at most NLM_MAX_OFF of the pixels."""
    d = _kernel_against_twin(stages.res.normalized[:images], precision)
    assert int((d > 1e-6).sum()) <= NLM_MAX_OFF * d.numel()


@pytest.mark.card
@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("hw,images", [
    ((2, 2), 3), ((5, 37), 3), ((33, 70), 3), ((64, 64), 3), ((70, 67), 3),
    ((131, 195), 3), ((32, 32), 4), ((48, 64), 4), ((40, 24), 4)])
def test_kernel_e_on_small_and_ragged_frames(card, hw, images, precision):
    """Frames smaller than the halo, no multiple of the tiles or strips,
    and where the kernel's two bodies meet: within NLM_ATOL."""
    g = torch.Generator().manual_seed(3)
    _kernel_against_twin(torch.rand((images, *hw), generator=g).to(card),
                         precision)
