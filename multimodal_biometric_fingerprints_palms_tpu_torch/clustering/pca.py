"""PCA of the port (the JAX package's ``clustering/pca.py``): one (D, D)
covariance eigendecomposition on ``device`` (default: the card). Eigenvector signs
(and bases inside a degenerate eigenvalue) are the solver's own, so
components agree with the JAX package's up to sign."""

from __future__ import annotations

import torch

from ..utils.device import full_float32, resolve_device
from .kmeans import as_tensor


def pca_reduce(x, n_components: int, device=None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (reduced (N, C), components (C, D), explained_variance (C,)),
    on ``device`` (default: the card)."""
    x = as_tensor(x, resolve_device(device, "pca_reduce"))
    with full_float32():
        mean = torch.mean(x, dim=0, keepdim=True)
        xc = x - mean
        denom = torch.tensor(float(max(x.shape[0] - 1, 1)), device=x.device)
        cov = (xc.T @ xc) / denom
        evals, evecs = torch.linalg.eigh(cov)          # ascending
        comp = torch.flip(evecs, dims=[1])[:, :n_components].T
        var = torch.flip(evals, dims=[0])[:n_components]
        return xc @ comp.T, comp, var
