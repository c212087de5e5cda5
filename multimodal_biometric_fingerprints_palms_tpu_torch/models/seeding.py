"""Seeded weights for the port's models, drawn as flax initialises their
JAX counterparts (lecun normal kernels, zero biases, unit ``g``, unit
BatchNorm) from an explicit ``torch.Generator``. Flax's own draws cannot
be reproduced without flax: the same seed gives the same weights on every
machine, but not the JAX package's."""

from __future__ import annotations

import math

import torch

from .projection_head import WeightNormDense

# flax's lecun_normal: a normal truncated at +-2 std, scaled so that the
# truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=g)


def seed_weights(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Initialise ``model`` (on the CPU) as flax initialises its JAX
    counterpart, from ``torch.Generator().manual_seed(seed)``, in module
    order: the same seed gives the same weights on every machine."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, WeightNormDense):
                _lecun_normal_(mod.v, mod.v.shape[0], g)
                mod.g.fill_(1.0)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()
    return model
