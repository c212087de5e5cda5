"""Crossing-number minutiae extraction (port of ``features/minutiae.py``).

CN = 1/2 * sum |P[i] - P[i+1]| over the 8-neighbour ring for every pixel at
once; the first K candidate pixels in row-major order are compacted into
fixed-size slots with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import traced


class MinutiaeSet(NamedTuple):
    """Fixed-K minutiae: xy, type, orientation, quality, coherence,
    angular_stability, plus a validity mask."""
    xy: torch.Tensor                  # (..., K, 2) float32 (x, y)
    minutia_type: torch.Tensor        # (..., K) int32: 0=ending, 1=bifurcation
    orientation: torch.Tensor         # (..., K) float32
    quality: torch.Tensor             # (..., K) float32
    coherence: torch.Tensor           # (..., K) float32
    angular_stability: torch.Tensor   # (..., K) float32
    valid: torch.Tensor               # (..., K) bool

    @property
    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)

    def as_matrix(self) -> torch.Tensor:
        """(..., K, 7) matrix in the reference column order."""
        return torch.cat([
            self.xy,
            self.minutia_type[..., None].to(torch.float32),
            self.orientation[..., None],
            self.quality[..., None],
            self.coherence[..., None],
            self.angular_stability[..., None],
        ], dim=-1)


def from_matrix(mat: torch.Tensor, valid: torch.Tensor) -> MinutiaeSet:
    """Build a MinutiaeSet from the reference (…, K, 7) matrix layout."""
    return MinutiaeSet(
        xy=mat[..., :2].to(torch.float32),
        minutia_type=mat[..., 2].to(torch.int32),
        orientation=mat[..., 3].to(torch.float32),
        quality=mat[..., 4].to(torch.float32),
        coherence=mat[..., 5].to(torch.float32),
        angular_stability=mat[..., 6].to(torch.float32),
        valid=valid.to(torch.bool),
    )


def minutiae_from_numpy(d, device="cpu") -> MinutiaeSet:
    """A MinutiaeSet on ``device`` from array-likes keyed by the field names
    (a mapping, or any NamedTuple with the same fields, such as the JAX
    package's ``MinutiaeSet`` of numpy arrays)."""
    if hasattr(d, "_asdict"):
        d = d._asdict()
    dtypes = dict(xy=np.float32, minutia_type=np.int32, valid=np.bool_)
    return MinutiaeSet(**{
        f: torch.from_numpy(np.ascontiguousarray(
            np.asarray(d[f]).astype(dtypes.get(f, np.float32)))).to(device)
        for f in MinutiaeSet._fields})


def crossing_number(skel: torch.Tensor) -> torch.Tensor:
    """CN map over (..., H, W) boolean skeletons (int32)."""
    sk = skel.to(torch.int32)
    h, w = sk.shape[-2:]
    pad = F.pad(sk, (1, 1, 1, 1))

    def sh(dy, dx):
        return pad[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    # ring order: E, NE, N, NW, W, SW, S, SE
    ring = [sh(0, 1), sh(-1, 1), sh(-1, 0), sh(-1, -1),
            sh(0, -1), sh(1, -1), sh(1, 0), sh(1, 1)]
    cn = torch.zeros_like(sk)
    for i in range(8):
        cn = cn + torch.abs(ring[i] - ring[(i + 1) % 8])
    return cn // 2


@traced("features.extract")
def extract_minutiae(skel: torch.Tensor, k: int = 64) -> MinutiaeSet:
    """Up to ``k`` minutiae per image from (..., H, W) skeletons:
    skeleton pixels with CN 1 (ending) or 3 (bifurcation), border excluded,
    taken in row-major order. Quality fields are zero; ``postprocess_minutiae``
    fills them."""
    sk = skel.to(torch.bool)
    h, w = sk.shape[-2:]
    lead = sk.shape[:-2]
    dev = sk.device

    cn = crossing_number(sk)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    interior = (ys >= 1) & (ys <= h - 2) & (xs >= 1) & (xs <= w - 2)
    cand = sk & interior & ((cn == 1) | (cn == 3))
    is_bif = (cn == 3).to(torch.int32)

    hw = h * w
    flat = cand.reshape(-1, hw)
    b = flat.shape[0]
    # the pixel of rank r (1-based) is the first position whose running
    # candidate count reaches r
    ranks = torch.cumsum(flat.to(torch.int32), dim=-1)
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=dev)
    top_idx = torch.searchsorted(ranks, targets.expand(b, k).contiguous())
    top_idx = torch.clamp(top_idx, max=hw - 1)
    out_y = (top_idx // w).to(torch.int32)
    out_x = (top_idx % w).to(torch.int32)
    out_t = torch.gather(is_bif.reshape(b, hw), 1, top_idx)

    count = flat.to(torch.int32).sum(dim=-1, keepdim=True)
    valid = torch.arange(k, device=dev)[None, :] < torch.clamp(count, max=k)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out_x = torch.where(valid, out_x, zero)
    out_y = torch.where(valid, out_y, zero)
    out_t = torch.where(valid, out_t, zero)

    zeros = torch.zeros((b, k), dtype=torch.float32, device=dev)
    ms = MinutiaeSet(
        xy=torch.stack([out_x, out_y], dim=-1).to(torch.float32),
        minutia_type=out_t.to(torch.int32),
        orientation=zeros,
        quality=zeros,
        coherence=zeros,
        angular_stability=zeros,
        valid=valid,
    )
    return MinutiaeSet(*(a.reshape(lead + a.shape[1:]) for a in ms))
