"""Training losses of the port (the JAX package's ``models/losses.py``).

- ``nt_xent_loss``: the two-view contrastive loss of the SSL model. The
  positive pair is masked out of the denominator as well as the self term,
  as the JAX function (and the reference it rebuilds) does; that is not
  SimCLR's textbook form, and the port keeps it.
- Segmentation: ``focal_tversky_loss``, ``dice_coeff``, ``dice_loss``,
  ``iou_score`` on sigmoid probabilities, and ``bce_with_logits``, optax's
  ``sigmoid_binary_cross_entropy`` averaged over every element.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                           min=1e-12)


def nt_xent_loss(z_i: torch.Tensor, z_j: torch.Tensor,
                 temperature: float = 0.5) -> torch.Tensor:
    """Normalized temperature-scaled cross-entropy over a two-view batch;
    ``z_i``, ``z_j``: (B, D) projections of the two views."""
    b = z_i.shape[0]
    t = torch.tensor(temperature, dtype=z_i.dtype, device=z_i.device)
    z_i, z_j = _unit(z_i), _unit(z_j)
    reps = torch.cat([z_i, z_j], dim=0)                          # (2B, D)
    sim = (reps @ reps.T) / t                                    # (2B, 2B)
    n = 2 * b
    idx = torch.arange(n, device=z_i.device)
    mask = torch.ones((n, n), dtype=torch.bool, device=z_i.device)
    mask[idx, idx] = False                                       # self
    mask[idx, (idx + b) % n] = False                             # positive
    positives = torch.exp(torch.sum(z_i * z_j, dim=-1) / t)
    positives = torch.cat([positives, positives], dim=0)         # (2B,)
    denom = torch.sum(torch.exp(sim) * mask, dim=1)
    return torch.mean(-torch.log(positives / torch.clamp(denom, min=1e-12)))


def focal_tversky_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.7, beta: float = 0.3,
                       gamma: float = 0.75, eps: float = 1e-6) -> torch.Tensor:
    """Focal Tversky loss on sigmoid probabilities."""
    p = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1)
    tp = torch.sum(p * t)
    fp = torch.sum(p * (1.0 - t))
    fn = torch.sum((1.0 - p) * t)
    tversky = (tp + eps) / (tp + alpha * fn + beta * fp + eps)
    return (1.0 - tversky) ** gamma


def dice_coeff(logits: torch.Tensor, targets: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    p = (torch.sigmoid(logits) > 0.5).to(torch.float32).reshape(-1)
    t = targets.reshape(-1)
    inter = torch.sum(p * t)
    return (2.0 * inter + eps) / (torch.sum(p) + torch.sum(t) + eps)


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    p = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1)
    inter = torch.sum(p * t)
    return 1.0 - (2.0 * inter + eps) / (torch.sum(p) + torch.sum(t) + eps)


def iou_score(logits: torch.Tensor, targets: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    p = (torch.sigmoid(logits) > 0.5).to(torch.float32).reshape(-1)
    t = targets.reshape(-1)
    inter = torch.sum(p * t)
    union = torch.sum(p) + torch.sum(t) - inter
    return (inter + eps) / (union + eps)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``, averaged:
    ``-t log sigmoid(x) - (1 - t) log sigmoid(-x)``."""
    return torch.mean(-targets * F.logsigmoid(logits)
                      - (1.0 - targets) * F.logsigmoid(-logits))
