"""SSL model of the port (the JAX package's ``models/ssl_model.py``):
backbone -> projection head -> optional BYOL/SimSiam predictor.

``forward`` runs in float32 without TF32 (``utils.device.full_float32``),
as the JAX package computes. Call ``.eval()`` for inference: BatchNorm
then uses its running statistics and dropout is off (the JAX package's
``train=False``). In train mode (``train=True`` there) BatchNorm moves its
running statistics as flax does and the projection head's dropout draws
flax's masks from ``dropout_rng``, the key the JAX step hands
``rngs={"dropout": ...}``. ``batch_group`` makes the forward one rank's
part of a data-parallel step (``models/backbone.py``'s note).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..utils.device import full_float32
from .backbone import EFFNETV2_S, STAGE_PLANS, FingerprintBackbone
from .projection_head import ProjectionHead, batch_norm1d


class Predictor(nn.Module):
    """BYOL/SimSiam predictor MLP."""

    def __init__(self, input_dim: int, hidden_dim: int = 512,
                 output_dim: int = 256):
        super().__init__()
        self.Dense_0 = nn.Linear(input_dim, hidden_dim)
        self.BatchNorm_0 = batch_norm1d(hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, output_dim)

    def forward(self, x, batch_group=None):
        return self.Dense_1(F.relu(self.BatchNorm_0(self.Dense_0(x),
                                                    batch_group)))


class SSLModel(nn.Module):
    def __init__(self, backbone_name: str = "effnetv2_s",
                 embedding_dim: int = 756, proj_hidden_dim: int = 512,
                 proj_output_dim: int = 256, proj_num_layers: int = 2,
                 use_predictor: bool = True):
        super().__init__()
        self.backbone_name = backbone_name
        self.embedding_dim = embedding_dim
        self.proj_output_dim = proj_output_dim
        plan = STAGE_PLANS.get(backbone_name, EFFNETV2_S)
        self.backbone = FingerprintBackbone(embedding_dim=embedding_dim,
                                            stage_plan=plan)
        self.projection_head = ProjectionHead(
            embedding_dim, hidden_dim=proj_hidden_dim,
            output_dim=proj_output_dim, num_layers=proj_num_layers)
        self.predictor = (Predictor(proj_output_dim, proj_hidden_dim,
                                    proj_output_dim)
                          if use_predictor else None)

    def forward(self, x, return_embedding: bool = False, dropout_rng=None,
                batch_group=None):
        with full_float32():
            embedding = self.backbone(x, batch_group)
            projection = self.projection_head(embedding, dropout_rng,
                                              batch_group)
            if self.predictor is not None:
                projection = self.predictor(projection, batch_group)
        if return_embedding:
            return projection, embedding
        return projection
