"""SimCLR/BYOL projection head of the port (the JAX package's
``models/projection_head.py``): weight-normalised linear layers +
BatchNorm + ReLU + dropout 0.1, residual iff the input and output widths
match, L2-normalised output.

``WeightNormDense`` keeps the JAX parameters ``v`` (in, out), ``g`` (out,)
and ``bias`` and computes ``w = v * (g / max(||v||, 1e-12))`` with the
norm over the input axis. ``torch.nn.utils.parametrizations.weight_norm``
is not used: it has no clamp.

Dropout in train mode draws flax's masks bit for bit: layer ``i``'s key
is flax's ``make_rng("dropout")`` in the module ``<name>/Dropout_<i>``,
``utils.threefry.fold_in_static(rng, (name, "Dropout_<i>", 1))`` of the
step's dropout key ``rng``; the mask is ``uniform < 0.9``, drawn on
``x``'s device, and kept values
are divided by 0.9 (a tensor divisor: the card turns a division by a
Python scalar into a product with its reciprocal). With a ``batch_group``
(``models/backbone.py``'s note) the mask is drawn for the whole batch, as
the JAX step draws it over the global array, and a rank keeps its rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from ..utils import threefry
from .backbone import FlaxBatchNorm1d


def l2_normalize(y: torch.Tensor) -> torch.Tensor:
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                           min=1e-12)


class WeightNormDense(nn.Module):
    """Dense layer with weight normalization (w = g * v / ||v||)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.v = nn.Parameter(torch.empty(in_features, features))
        self.g = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.kaiming_normal_(self.v.T, nonlinearity="linear")

    def forward(self, x):
        norm = torch.linalg.vector_norm(self.v, dim=0)
        w = self.v * (self.g / torch.clamp(norm, min=1e-12))
        y = x @ w
        return y + self.bias if self.bias is not None else y


def batch_norm1d(ch: int) -> nn.BatchNorm1d:
    return FlaxBatchNorm1d(ch, eps=1e-5, momentum=0.01)


def flax_dropout(x: torch.Tensor, rng, path: tuple, rate: float,
                 batch_group=None) -> torch.Tensor:
    """flax's ``nn.Dropout(rate)`` at module ``path`` under the dropout key
    ``rng`` (a ``utils.threefry`` key), its first call in the apply; with
    ``batch_group``, this rank's rows of the whole batch's mask."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    key = threefry.fold_in_static(rng, tuple(path) + (1,))
    if batch_group is None:
        mask = threefry.bernoulli(torch.tensor(key, device=x.device), keep,
                                  tuple(x.shape))
    else:
        n, r = x.shape[0], dist.get_rank(batch_group)
        mask = threefry.bernoulli(
            torch.tensor(key, device=x.device), keep,
            (n * dist.get_world_size(batch_group),) + tuple(x.shape[1:]))
        mask = mask[r * n:(r + 1) * n]
    kept = x / torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, kept, torch.zeros_like(x))


class ProjectionHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 512,
                 output_dim: int = 256, num_layers: int = 2,
                 dropout: float = 0.1, use_residual: bool = True,
                 name: str = "projection_head"):
        super().__init__()
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self.num_layers = num_layers
        self.residual = use_residual and input_dim == output_dim
        self.dropout, self.name = dropout, name
        if num_layers == 1:
            self.Dense_0 = nn.Linear(input_dim, output_dim)
            return
        widths = [input_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"WeightNormDense_{i}",
                            WeightNormDense(widths[i], hidden_dim))
            self.add_module(f"BatchNorm_{i}", batch_norm1d(hidden_dim))
        self.Dense_0 = nn.Linear(hidden_dim, output_dim)

    def forward(self, x, dropout_rng=None, batch_group=None):
        """``dropout_rng``: the step's dropout key, needed in train mode;
        ``batch_group``: see ``models/backbone.py``'s note."""
        if self.training and self.num_layers > 1 and dropout_rng is None:
            raise ValueError("the projection head's dropout needs a key in "
                             "train mode (flax's rngs={'dropout': ...})")
        y = x
        for i in range(self.num_layers - 1):
            y = getattr(self, f"WeightNormDense_{i}")(y)
            y = F.relu(getattr(self, f"BatchNorm_{i}")(y, batch_group))
            if self.training:
                y = flax_dropout(y, dropout_rng, (self.name, f"Dropout_{i}"),
                                 self.dropout, batch_group)
        y = self.Dense_0(y)
        if self.residual:
            y = y + x
        return l2_normalize(y)
