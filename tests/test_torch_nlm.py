"""Port parity for non-local means: the port's ``nlm_denoise`` (on the CPU,
the plain twin of kernel E) against the JAX package's NLM kernels in
interpret mode, on inputs made from a numpy seed.

Tolerance: 1e-6 absolute, the bound ``tests/test_pallas_kernels.py`` holds
those kernels to against the XLA form. Every per-offset weight and value is
the same rounded number in both packages; the symmetric-pair kernel adds
its direct and mirror terms in another order than the offset order the port
uses, which moves the float32 sums by a few 1e-7.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from multimodal_biometric_fingerprints_palms_tpu.ops import (
    pallas_kernels as JK)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops import (
    denoise as TD)

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
