"""Two-stage agglomerative clustering of the port (the JAX package's
``clustering/agglomerative.py``): KMeans down to <= 512 centres, then
average-linkage merging of the centres under cosine distance, then each
point takes its centre's group.

Everything runs on ``device`` (default: the card; pass ``"cpu"`` to run
there). The merge loop runs with no host
synchronisation: each of the C - n_clusters merges recomputes the (C, C)
cosine matrix, masks inactive rows, columns and the diagonal, and takes the
first flat ``argmin`` (the JAX code's order). Groups are relabelled
0..n_clusters-1 by the rank of their root index, as ``jnp.unique(size=...)``
sorts them.
"""

from __future__ import annotations

import torch

from ..utils.device import full_float32, resolve_device
from .kmeans import as_tensor, kmeans


def _cosine_dist(a, b):
    floor = torch.tensor(1e-12, device=a.device)
    an = a / torch.maximum(torch.linalg.vector_norm(a, dim=-1, keepdim=True), floor)
    bn = b / torch.maximum(torch.linalg.vector_norm(b, dim=-1, keepdim=True), floor)
    return 1.0 - an @ bn.T


def _merge_centers(centers: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Average-linkage agglomeration of C centres down to n_clusters
    groups. Returns the group id of each centre."""
    c = centers.shape[0]
    dev = centers.device
    group = torch.arange(c, device=dev)
    active = torch.ones((c,), dtype=torch.bool, device=dev)
    cent = centers.clone()
    weight = torch.ones((c,), dtype=torch.float32, device=dev)
    eye = torch.eye(c, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    with full_float32():
        for _ in range(c - n_clusters):
            d = _cosine_dist(cent, cent)
            d = torch.where(active[:, None] & active[None, :], d, inf)
            d = torch.where(eye, inf, d)
            flat = torch.argmin(d)
            i, j = flat // c, flat % c
            i, j = torch.minimum(i, j), torch.maximum(i, j)
            wi, wj = weight[i], weight[j]
            new_c = (cent[i] * wi + cent[j] * wj) / (wi + wj)
            cent = cent.index_put((i.reshape(1),), new_c[None])
            weight = weight.index_put((i.reshape(1),), (wi + wj).reshape(1))
            active = active.index_put((j.reshape(1),),
                                      torch.zeros(1, dtype=torch.bool, device=dev))
            group = torch.where(group == group[j], group[i], group)
    roots = torch.unique(group, sorted=True)
    return torch.searchsorted(roots, group)


def agglomerative_fast(key, x, n_clusters: int, max_centers: int = 512,
                       kmeans_iters: int = 50, device=None) -> torch.Tensor:
    """Two-stage agglomerative labels for (N, D) embeddings, on ``device``
    (default: the card)."""
    device = resolve_device(device, "agglomerative_fast")
    x = as_tensor(x, device)
    n = x.shape[0]
    c = min(max_centers, n)
    if c <= n_clusters:
        labels, _, _ = kmeans(key, x, n_clusters, kmeans_iters, device)
        return labels
    coarse_labels, centers, _ = kmeans(key, x, c, kmeans_iters, device)
    center_group = _merge_centers(centers, n_clusters)
    return center_group[coarse_labels]
