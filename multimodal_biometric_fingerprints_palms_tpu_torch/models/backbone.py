"""Grayscale EfficientNetV2-class backbone of the port (the JAX package's
``models/backbone.py``), as ``nn.Module``s in NCHW.

The stage plans, block structure and widths are the JAX package's: the
EfficientNetV2-S plan (FusedMBConv stages 1-3, MBConv + squeeze-excite
stages 4-6), a 1-channel stem, a mean pool and a linear projection to
``embedding_dim`` with optional L2 norm. What follows the JAX module to the
digit:

- Convolutions pad as flax's ``"SAME"``: ``total = max((out - 1) * stride +
  k - n, 0)`` split as ``lo = total // 2``, ``hi = total - lo``, computed per
  call from the input size. A stride-2 3x3 on an even side pads (0, 1),
  not PyTorch's symmetric 1.
- Squeeze-excite's hidden width is ``int(0.25 x expanded channels)``
  (flax's ``SqueezeExcite(hidden)``), not timm's input-channel ratio.
- Submodules carry flax's auto-names in call order (``Conv_0``,
  ``BatchNorm_1``, ``FusedMBConv_3``, ``SqueezeExcite_0``, ``Dense_0``), so
  ``models/convert.py`` maps a JAX tree onto the ``state_dict`` by name.
- BatchNorm: epsilon 1e-5, flax's 0.99 decay. In train mode it
  normalises with the batch's biased variance (as both packages do) and
  moves the running statistics as flax does: ``ra = 0.99 ra + 0.01 s``
  with the *biased* batch variance, ``mean(x^2) - mean(x)^2`` clamped at 0
  (``nn.BatchNorm2d`` would take the unbiased one, scaled by n / (n - 1)).
- ``batch_group``, a forward argument of every module here: None, or the
  ``torch.distributed`` process group whose ranks each hold their own rows
  of one batch (a data-parallel training step, ``train/ssl_train.py``).
  With a group, train-mode BatchNorm normalises with the whole batch's
  statistics and moves its running statistics by them, as one device
  does on the whole batch; without one nothing of this runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.distributed as dist
from torch import nn

# (block, expand, channels, layers, stride, use_se)
EFFNETV2_S: tuple = (
    ("fused", 1, 24, 2, 1, False),
    ("fused", 4, 48, 4, 2, False),
    ("fused", 4, 64, 4, 2, False),
    ("mb", 4, 128, 6, 2, True),
    ("mb", 6, 160, 9, 1, True),
    ("mb", 6, 256, 15, 2, True),
)

# Small variant for tests / fast smoke runs.
EFFNETV2_TINY: tuple = (
    ("fused", 1, 16, 1, 1, False),
    ("fused", 2, 32, 2, 2, False),
    ("mb", 2, 48, 2, 2, True),
    ("mb", 4, 64, 2, 2, True),
)

STAGE_PLANS = {"effnetv2_s": EFFNETV2_S, "effnetv2_tiny": EFFNETV2_TINY}


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` padded as flax's ``"SAME"``, per call."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, groups=groups,
                         bias=bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same_pads(x.shape[-2], k, s)
        left, right = _same_pads(x.shape[-1], k, s)
        if (top, left) == (bottom, right):
            return F.conv2d(x, self.weight, self.bias, s, (top, left), 1,
                            self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, s, 0, 1, self.groups)


class _SumOverRanks(torch.autograd.Function):
    """``x`` summed over the ranks of ``group``. Its backward sums the
    incoming gradients over the ranks too: each rank's holds what flows
    through its own rows, and every row depends on the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FlaxStats:
    """Train-mode forward of a BatchNorm that updates its running
    statistics as flax's ``nn.BatchNorm`` does (see the module note); with
    a ``batch_group``, over the whole batch (``_global_forward``)."""

    def forward(self, x, batch_group=None):
        if not self.training:
            return super().forward(x)
        if batch_group is not None:
            return self._global_forward(x, batch_group)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            dims = [0] + list(range(2, x.ndim))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            self.running_mean.copy_(0.99 * self.running_mean + 0.01 * mean)
            self.running_var.copy_(0.99 * self.running_var + 0.01 * var)
        return y

    def _global_forward(self, x, group):
        """This rank's rows normalised with the mean and biased variance of
        every rank's rows, as one device normalises the whole batch: the
        mean from the summed sums, the variance from the summed squared
        deviations from it (two all-reduces, both under autograd). The
        running statistics move by the global mean and ``mean(x^2) -
        mean^2``, as on one device."""
        c = x.shape[1]
        dims = [0] + list(range(2, x.ndim))
        shape = [1, c] + [1] * (x.ndim - 2)
        count = torch.tensor(float(x.numel() // c
                                   * dist.get_world_size(group)),
                             dtype=x.dtype, device=x.device)
        sums = _SumOverRanks.apply(
            torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims).detach()]),
            group) / count
        mean = sums[:c]
        d = x - mean.reshape(shape)
        var = _SumOverRanks.apply((d * d).sum(dim=dims), group) / count
        y = d * torch.rsqrt(var + self.eps).reshape(shape)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        with torch.no_grad():
            m = mean.detach()
            rvar = torch.clamp(sums[c:].detach() - m * m, min=0.0)
            self.running_mean.copy_(0.99 * self.running_mean + 0.01 * m)
            self.running_var.copy_(0.99 * self.running_var + 0.01 * rvar)
        return y


class FlaxBatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class FlaxBatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


def batch_norm(ch: int) -> nn.BatchNorm2d:
    return FlaxBatchNorm2d(ch, eps=1e-5, momentum=0.01)


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, se_ratio: float = 0.25):
        super().__init__()
        hidden = max(1, int(features * se_ratio))
        self.Conv_0 = nn.Conv2d(features, hidden, 1)
        self.Conv_1 = nn.Conv2d(hidden, features, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.Conv_1(F.silu(self.Conv_0(s)))
        return x * torch.sigmoid(s)


class FusedMBConv(nn.Module):
    def __init__(self, inp: int, features: int, expand: int, stride: int = 1):
        super().__init__()
        self.expand, self.stride = expand, stride
        self.residual = stride == 1 and inp == features
        if expand != 1:
            hidden = inp * expand
            self.Conv_0 = SameConv2d(inp, hidden, 3, stride, bias=False)
            self.BatchNorm_0 = batch_norm(hidden)
            self.Conv_1 = SameConv2d(hidden, features, 1, bias=False)
            self.BatchNorm_1 = batch_norm(features)
        else:
            self.Conv_0 = SameConv2d(inp, features, 3, stride, bias=False)
            self.BatchNorm_0 = batch_norm(features)

    def forward(self, x, batch_group=None):
        y = self.BatchNorm_0(self.Conv_0(x), batch_group)
        y = F.silu(y)
        if self.expand != 1:
            y = self.BatchNorm_1(self.Conv_1(y), batch_group)
        return y + x if self.residual else y


class MBConv(nn.Module):
    def __init__(self, inp: int, features: int, expand: int, stride: int = 1,
                 use_se: bool = True):
        super().__init__()
        hidden = inp * expand
        self.residual = stride == 1 and inp == features
        self.Conv_0 = SameConv2d(inp, hidden, 1, bias=False)
        self.BatchNorm_0 = batch_norm(hidden)
        self.Conv_1 = SameConv2d(hidden, hidden, 3, stride, groups=hidden,
                                 bias=False)
        self.BatchNorm_1 = batch_norm(hidden)
        self.SqueezeExcite_0 = SqueezeExcite(hidden) if use_se else None
        self.Conv_2 = SameConv2d(hidden, features, 1, bias=False)
        self.BatchNorm_2 = batch_norm(features)

    def forward(self, x, batch_group=None):
        y = F.silu(self.BatchNorm_0(self.Conv_0(x), batch_group))
        y = F.silu(self.BatchNorm_1(self.Conv_1(y), batch_group))
        if self.SqueezeExcite_0 is not None:
            y = self.SqueezeExcite_0(y)
        y = self.BatchNorm_2(self.Conv_2(y), batch_group)
        return y + x if self.residual else y


class FingerprintBackbone(nn.Module):
    """1-channel CNN encoder -> pooled features -> linear embedding."""

    def __init__(self, embedding_dim: int = 756, stage_plan=EFFNETV2_S,
                 stem_features: int = 24, head_features: int = 1280,
                 l2_normalize: bool = True):
        super().__init__()
        self.l2_normalize = l2_normalize
        self.Conv_0 = SameConv2d(1, stem_features, 3, 2, bias=False)
        self.BatchNorm_0 = batch_norm(stem_features)
        self.blocks: list[str] = []
        counts = {"fused": 0, "mb": 0}
        ch = stem_features
        for block, expand, feats, layers, stride, use_se in stage_plan:
            for li in range(layers):
                s = stride if li == 0 else 1
                if block == "fused":
                    name, mod = (f"FusedMBConv_{counts['fused']}",
                                 FusedMBConv(ch, feats, expand, s))
                else:
                    name, mod = (f"MBConv_{counts['mb']}",
                                 MBConv(ch, feats, expand, s, use_se))
                counts[block] += 1
                self.add_module(name, mod)
                self.blocks.append(name)
                ch = feats
        self.Conv_1 = SameConv2d(ch, head_features, 1, bias=False)
        self.BatchNorm_1 = batch_norm(head_features)
        self.Dense_0 = nn.Linear(head_features, embedding_dim)

    def forward(self, x, batch_group=None):
        # x: (B, H, W) or (B, H, W, 1) grayscale in [0, 1], or (B, 1, H, W)
        if x.ndim == 4 and x.shape[-1] == 1 and x.shape[1] != 1:
            x = x[..., 0]
        if x.ndim == 3:
            x = x[:, None]
        y = F.silu(self.BatchNorm_0(self.Conv_0(x), batch_group))
        for name in self.blocks:
            y = getattr(self, name)(y, batch_group)
        y = F.silu(self.BatchNorm_1(self.Conv_1(y), batch_group))
        emb = self.Dense_0(y.mean(dim=(2, 3)))
        if self.l2_normalize:
            emb = emb / torch.clamp(torch.linalg.vector_norm(
                emb, dim=-1, keepdim=True), min=1e-12)
        return emb
