"""KMeans of the port (the JAX package's ``clustering/kmeans.py``):
kmeans++ seeding, then 50 full-batch Lloyd steps in float32, on
``device`` (default: the card; pass ``"cpu"`` to run there).

Seeding draws what the JAX function draws from the same key
(``utils/threefry.py``): ``split`` -> ``randint`` for the first centre,
then one ``split`` and one Gumbel-max ``categorical`` per further centre.
The chain of keys does not depend on the data, so every Gumbel draw is
made on the host first and copied to the device in one transfer; the
seeding loop then runs with no host synchronisation (agglomerative seeds
512 centres). Each step's distance to the newest centre updates the
running minimum (the JAX code recomputes all chosen columns and takes
their minimum: the same values). Distances take the matmul form
``|x|^2 - 2 x c^T + |c|^2`` and the centre update ``sums / max(counts, 1)``
divides by a tensor, without TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import threefry
from ..utils.device import full_float32, resolve_device


def _pairwise_sqdist(x, c):
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    cc = torch.sum(c * c, dim=-1)
    return xx - 2.0 * (x @ c.T) + cc[None, :]


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (a tensor or anything numpy takes) as ``dtype`` on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def kmeans_plus_plus_init(key, x, n_clusters: int,
                          device=None) -> torch.Tensor:
    """kmeans++ seeding (D^2-weighted sampling): (C, D) centres on
    ``device`` (default: the card). ``key`` is a ``threefry`` key
    (``threefry.key(seed)``)."""
    x = as_tensor(x, resolve_device(device, "kmeans_plus_plus_init"))
    n = x.shape[0]
    k0, key = threefry.split(key)
    first = int(threefry.randint(k0, (), 0, n))
    noise = np.empty((max(n_clusters - 1, 0), n), np.float32)
    for i in range(n_clusters - 1):
        key, sub = threefry.split(key)
        noise[i] = threefry.gumbel(sub, (n,))
    noise = torch.from_numpy(noise).to(x.device)
    tiny = torch.tensor(1e-30, device=x.device)
    floor = torch.tensor(1e-12, device=x.device)
    with full_float32():
        centers = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype,
                              device=x.device)
        centers[0] = x[first]
        dmin = _pairwise_sqdist(x, centers[:1])[:, 0]
        for i in range(1, n_clusters):
            probs = dmin / torch.maximum(dmin.sum(), floor)
            idx = torch.argmax(noise[i - 1] + torch.log(torch.maximum(probs, tiny)))
            centers[i] = x.index_select(0, idx.reshape(1))[0]
            dmin = torch.minimum(dmin, _pairwise_sqdist(x, centers[i:i + 1])[:, 0])
    return centers


def kmeans(key, x, n_clusters: int, n_iters: int = 50, device=None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (labels (N,), centers (C, D), inertia scalar), tensors on
    ``device`` (default: the card)."""
    device = resolve_device(device, "kmeans")
    x = as_tensor(x, device)
    centers = kmeans_plus_plus_init(key, x, n_clusters, device)
    one = torch.ones((), device=x.device)
    with full_float32():
        for _ in range(n_iters):
            labels = torch.argmin(_pairwise_sqdist(x, centers), dim=-1)
            onehot = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype)
            sums = onehot.T @ x
            counts = onehot.sum(dim=0)[:, None]
            centers = torch.where(counts > 0, sums / torch.maximum(counts, one),
                                  centers)
        d2 = _pairwise_sqdist(x, centers)
        labels = torch.argmin(d2, dim=-1)
        inertia = torch.sum(torch.min(d2, dim=-1).values)
    return labels, centers, inertia
