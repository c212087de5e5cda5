"""UNet++ (nested U-Net) segmentation model of the port (the JAX package's
``models/unetpp.py``), as ``nn.Module``s in NCHW: (B, C, H, W) in,
(B, out_channels, H, W) logits out (the JAX model is NHWC).

ConvBlock = 2 x (3x3 conv + BatchNorm + ReLU); nested dense skip nodes
x_{i,j}; bilinear x2 upsampling; a 1x1 final conv. Default filters
[64, 128, 256, 512, 1024]. ``jax.image.resize(..., "bilinear")`` at x2
renormalises its kernel at the edges, which gives what
``F.interpolate(scale_factor=2, mode="bilinear", align_corners=False)``
gives (it clamps the source coordinate): the CPU tests hold the two equal.
Blocks carry flax's auto-names in call order (``ConvBlock_0`` ...
``ConvBlock_14``, ``Conv_0``) for ``models/convert.py``. ``forward`` runs
in float32 without TF32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import full_float32
from .backbone import batch_norm


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, features, 3, padding=1, bias=False)
        self.BatchNorm_0 = batch_norm(features)
        self.Conv_1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.BatchNorm_1 = batch_norm(features)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return F.relu(self.BatchNorm_1(self.Conv_1(x)))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def _pool2(x):
    return F.max_pool2d(x, 2, 2)


# (level i, node j) of each ConvBlock in call order
_NODES = ((0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (0, 1), (1, 1), (2, 1),
          (3, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3), (0, 4))


class NestedUNet(nn.Module):
    def __init__(self, filters: Sequence[int] = (64, 128, 256, 512, 1024),
                 out_channels: int = 1, in_channels: int = 3):
        super().__init__()
        f = list(filters)
        for k, (i, j) in enumerate(_NODES):
            # x_{i,0} takes the pooled level above (or the input); x_{i,j}
            # the j nodes of its level and the upsampled x_{i+1,j-1}
            in_ch = ((in_channels if i == 0 else f[i - 1]) if j == 0
                     else j * f[i] + f[i + 1])
            self.add_module(f"ConvBlock_{k}", ConvBlock(in_ch, f[i]))
        self.Conv_0 = nn.Conv2d(f[0], out_channels, 1)

    def forward(self, x):
        with full_float32():
            nodes: dict = {}
            for k, (i, j) in enumerate(_NODES):
                block = getattr(self, f"ConvBlock_{k}")
                if j == 0:
                    inp = x if i == 0 else _pool2(nodes[i - 1, 0])
                else:
                    inp = torch.cat([nodes[i, m] for m in range(j)]
                                    + [_up2(nodes[i + 1, j - 1])], dim=1)
                nodes[i, j] = block(inp)
            return self.Conv_0(nodes[0, 4])
