"""The port's entry point against ``__graft_entry__.entry``: the flagship
SSL forward (EfficientNetV2-S, 756 -> 512 -> 256, predictor on) on the same
example batch, with the JAX entry's weights carried across; within 1e-4
(measured 1.5e-07). Both functions are called on two of the eight images
to bound the JAX side's time (BatchNorm in eval mode treats rows alone)."""

import jax
import numpy as np
import torch

import __graft_entry__
from multimodal_biometric_fingerprints_palms_tpu_torch.entry import entry
from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
    load_jax_variables)

torch.set_num_threads(1)


def test_entry_matches_graft_entry():
    jfn, (jx,) = __graft_entry__.entry()
    # the JAX entry's weights, from its function's closure
    variables = dict(zip(jfn.__code__.co_freevars,
                         (c.cell_contents for c in jfn.__closure__)))["variables"]
    fn, (x,) = entry(device="cpu")
    assert isinstance(x, torch.Tensor) and x.shape == (8, 224, 224)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert not fn.training
    load_jax_variables(fn, jax.device_get(variables))
    with torch.no_grad():
        got = fn(x[:2]).numpy()
    want = np.asarray(jfn(jx[:2]))
    assert got.shape == want.shape == (2, 256)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_entry_weights_are_seeded():
    """Two calls give the same model: the weights come from seed 0."""
    a, _ = entry(device="cpu")
    b, _ = entry(device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
