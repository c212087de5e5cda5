"""Clustering quality metrics of the port (the JAX package's
``clustering/metrics.py``): the cosine silhouette, Davies-Bouldin and
Calinski-Harabasz as pairwise reductions on ``device`` (default: the
card; pass ``"cpu"`` to run there), and the
clustering report, which subsamples to ``max_points`` with
``np.random.default_rng(seed).choice`` as the JAX function does.

The JAX functions' quirks are kept: an empty cluster's mean distance is
0 in the silhouette's ``b``; every count is clamped to at least 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import full_float32, resolve_device
from .kmeans import as_tensor


def _inputs(x, labels, device, what):
    device = resolve_device(device, what)
    return as_tensor(x, device), as_tensor(labels, device, torch.int64)


def _onehot(labels: torch.Tensor, n_clusters: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels, n_clusters).to(torch.float32)


def _cosine_dist_matrix(x):
    floor = torch.tensor(1e-12, device=x.device)
    xn = x / torch.maximum(torch.linalg.vector_norm(x, dim=-1, keepdim=True), floor)
    return torch.clamp(1.0 - xn @ xn.T, 0.0, 2.0)


def silhouette_score_cosine(x, labels, n_clusters: int,
                            device=None) -> torch.Tensor:
    x, labels = _inputs(x, labels, device, "silhouette_score_cosine")
    one = torch.ones((), device=x.device)
    with full_float32():
        d = _cosine_dist_matrix(x)
        onehot = _onehot(labels, n_clusters)
        counts = onehot.sum(dim=0)
        sums = d @ onehot
        own = counts[labels]
        a = sums.gather(1, labels[:, None])[:, 0] / torch.maximum(own - 1, one)
        mean_other = sums / torch.maximum(counts[None, :], one)
        mean_other = torch.where(onehot > 0, torch.inf, mean_other)
        b = torch.min(mean_other, dim=1).values
        s = (b - a) / torch.maximum(torch.maximum(a, b),
                                    torch.tensor(1e-12, device=x.device))
        s = torch.where(own > 1, s, torch.zeros((), device=x.device))
        return torch.mean(s)


def _centroids(x, labels, n_clusters):
    onehot = _onehot(labels, n_clusters)
    counts = torch.maximum(onehot.sum(dim=0), torch.ones((), device=x.device))
    return onehot, counts, (onehot.T @ x) / counts[:, None]


def davies_bouldin_index(x, labels, n_clusters: int,
                         device=None) -> torch.Tensor:
    x, labels = _inputs(x, labels, device, "davies_bouldin_index")
    with full_float32():
        onehot, counts, centroids = _centroids(x, labels, n_clusters)
        dev = torch.linalg.vector_norm(x - centroids[labels], dim=-1)
        scatter = (onehot.T @ dev) / counts
        cd = torch.linalg.vector_norm(centroids[:, None] - centroids[None, :],
                                      dim=-1)
        ratio = (scatter[:, None] + scatter[None, :]) / torch.maximum(
            cd, torch.tensor(1e-12, device=x.device))
        eye = torch.eye(n_clusters, dtype=torch.bool, device=x.device)
        ratio = torch.where(eye, -torch.inf, ratio)
        return torch.mean(torch.max(ratio, dim=-1).values)


def calinski_harabasz_index(x, labels, n_clusters: int,
                            device=None) -> torch.Tensor:
    x, labels = _inputs(x, labels, device, "calinski_harabasz_index")
    n = x.shape[0]
    with full_float32():
        _, counts, centroids = _centroids(x, labels, n_clusters)
        overall = torch.mean(x, dim=0)
        between = torch.sum(counts * torch.sum((centroids - overall) ** 2, dim=-1))
        within = torch.sum((x - centroids[labels]) ** 2)
        scalar = lambda v: torch.tensor(float(v), device=x.device)
        return (between / torch.maximum(within, scalar(1e-12))
                * scalar(n - n_clusters) / scalar(max(n_clusters - 1, 1)))


def evaluate_clustering(x, labels, n_clusters: int, max_points: int = 5000,
                        seed: int = 0, device=None) -> dict:
    """Clustering report: metrics on a <= max_points subsample, cluster
    sizes, embedding summary stats. The metrics run on ``device`` (default:
    the card); the sizes and stats are numpy, as in the JAX function."""
    device = resolve_device(device, "evaluate_clustering")
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    labels = (labels.detach().cpu().numpy() if isinstance(labels, torch.Tensor)
              else np.asarray(labels))
    n = x.shape[0]
    if n > max_points:
        idx = np.random.default_rng(seed).choice(n, max_points, replace=False)
        xs, ls = x[idx], labels[idx]
    else:
        xs, ls = x, labels
    sizes = np.bincount(labels, minlength=n_clusters).tolist()
    xt, lt = _inputs(xs, ls, device, "evaluate_clustering")
    return {
        "silhouette_cosine": float(
            silhouette_score_cosine(xt, lt, n_clusters, device)),
        "davies_bouldin": float(davies_bouldin_index(xt, lt, n_clusters, device)),
        "calinski_harabasz": float(
            calinski_harabasz_index(xt, lt, n_clusters, device)),
        "cluster_sizes": sizes,
        "n_samples": int(n),
        "embedding_stats": {
            "mean": float(x.mean()), "std": float(x.std()),
            "min": float(x.min()), "max": float(x.max()),
        },
    }
