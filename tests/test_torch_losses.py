"""The port's training losses (``models/losses.py``) against the JAX
package's on the same numpy inputs: NT-Xent with its positive masked out
of the denominator, focal Tversky, dice (loss and coefficient), IoU and
optax's sigmoid binary cross-entropy, each within 1e-6, values and (for
the differentiable ones) gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu.models import losses as JL
from multimodal_biometric_fingerprints_palms_tpu_torch.models import losses as TL

torch.set_num_threads(1)


def _seg_inputs(seed, shape=(2, 16, 16, 1)):
    g = np.random.default_rng(seed)
    logits = (3.0 * g.standard_normal(shape)).astype(np.float32)
    targets = (g.random(shape) < 0.4).astype(np.float32)
    return logits, targets


@pytest.mark.parametrize("temperature", [0.5, 0.1])
@pytest.mark.parametrize("b,d", [(4, 16), (16, 256)])
def test_nt_xent_matches_jax(b, d, temperature):
    g = np.random.default_rng(b + d)
    zi, zj = (g.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    want, (gi, gj) = jax.value_and_grad(
        lambda a, c: JL.nt_xent_loss(a, c, temperature), argnums=(0, 1))(zi, zj)
    ti = torch.from_numpy(zi).requires_grad_()
    tj = torch.from_numpy(zj).requires_grad_()
    got = TL.nt_xent_loss(ti, tj, temperature)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), atol=1e-6)
    np.testing.assert_allclose(tj.grad.numpy(), np.asarray(gj), atol=1e-6)


def test_nt_xent_masks_the_positive_out_of_the_denominator():
    """The denominator holds only the 2B - 2 negatives: the loss is below
    SimCLR's textbook form, which keeps the positive there too."""
    g = np.random.default_rng(0)
    zi, zj = (torch.from_numpy(g.standard_normal((4, 8)).astype(np.float32))
              for _ in range(2))
    u = torch.cat([zi, zj]) / torch.cat([zi, zj]).norm(dim=-1, keepdim=True)
    sim = torch.exp(u @ u.T / 0.5)
    pos = torch.cat([sim.diagonal(4), sim.diagonal(4)])
    textbook = -torch.log(pos / (sim.sum(1) - sim.diagonal()))
    masked = -torch.log(pos / (sim.sum(1) - sim.diagonal() - pos))
    got = float(TL.nt_xent_loss(zi, zj))
    np.testing.assert_allclose(got, float(masked.mean()), rtol=1e-6)
    assert got < float(textbook.mean())


@pytest.mark.parametrize("name", ["focal_tversky_loss", "dice_loss",
                                  "bce_with_logits"])
@pytest.mark.parametrize("seed", [0, 1])
def test_segmentation_losses_match_jax(name, seed):
    logits, targets = _seg_inputs(seed)
    want, grad = jax.value_and_grad(getattr(JL, name))(logits, targets)
    x = torch.from_numpy(logits).requires_grad_()
    got = getattr(TL, name)(x, torch.from_numpy(targets))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), atol=1e-6)


@pytest.mark.parametrize("name", ["dice_coeff", "iou_score"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmentation_scores_match_jax(name, seed):
    logits, targets = _seg_inputs(seed)
    want = float(getattr(JL, name)(logits, targets))
    got = float(getattr(TL, name)(torch.from_numpy(logits),
                                  torch.from_numpy(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bce_is_finite_for_large_logits():
    x = jnp.asarray([-200.0, -30.0, 0.0, 30.0, 200.0], jnp.float32)
    t = jnp.asarray([1.0, 0.0, 1.0, 1.0, 0.0], jnp.float32)
    want = float(JL.bce_with_logits(x, t))
    got = float(TL.bce_with_logits(torch.from_numpy(np.asarray(x)),
                                   torch.from_numpy(np.asarray(t))))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)
