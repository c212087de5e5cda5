"""Enrolment by the frozen plain routes: uint8 frames to the enhancement
layer's mask and skeleton and the features layer's templates."""

from __future__ import annotations

import torch

from .plain.features.minutiae import extract_minutiae
from .plain.features.quality import postprocess_minutiae
from .plain.ops.cuda_kernels import bin_to_unit
from .plain.preprocessing.enhance import bf16, preprocess_fingerprint


def enrol(frames_u8: torch.Tensor, k: int, device, block: int,
          lowp: bool = False) -> tuple:
    """(mask, skeleton, (N, K, 7) template matrix, (N, K) valid) on the
    host for (N, H, W) uint8 frames, ``block`` frames at a time on
    ``device``. ``lowp`` is the control: the chain's float images and the
    templates' float fields in bfloat16."""
    parts = []
    for s in range(0, frames_u8.shape[0], block):
        x = bin_to_unit(frames_u8[s:s + block].to(device).to(torch.float32))
        res = preprocess_fingerprint(x, lowp=lowp)
        ms = postprocess_minutiae(extract_minutiae(res.skeleton, k=k),
                                  res.skeleton)
        mat = ms.as_matrix()
        parts.append((res.mask.cpu(), res.skeleton.cpu(),
                      (bf16(mat) if lowp else mat).cpu(), ms.valid.cpu()))
    return tuple(torch.cat(p) for p in zip(*parts))
