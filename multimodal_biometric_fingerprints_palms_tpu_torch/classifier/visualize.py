"""Embedding scatter of the port (the JAX package's
``classifier/visualize.py``): subsample to ``max_points``, reduce to 2-D
and draw the points coloured by cluster label.

The reduction runs in torch on ``device`` (the card unless the caller asks
for the CPU), as scikit-learn computes it for the JAX package:

- the subsample: ``np.random.default_rng(seed).choice(n, max_points,
  replace=False)``, on the host as there;
- ``method="tsne"`` (more than 5 points): PCA to 50 dimensions where the
  width exceeds 50, then exact t-SNE with perplexity ``max(2, min(30,
  (n - 1) // 3))`` on scikit-learn's schedule (the perplexity binary
  search, early exaggeration 12 for 250 iterations at momentum 0.5, then
  momentum 0.8 to 1,000 iterations, gains, ``learning_rate="auto"``, the
  PCA start scaled to a standard deviation of 1e-4, the progress and
  gradient-norm stops every 50 iterations). The JAX package runs
  scikit-learn's Barnes-Hut approximation of the same objective; exact
  t-SNE is O(N^2), which 3,000 points afford on the card. The PCA start
  is the exact top two components where scikit-learn's is a randomized
  SVD of seven power iterations;
- ``method="umap"`` (more than 5 points): the JAX package's fallback
  (``umap`` is not installed there), a spectral embedding of the
  symmetrised kNN connectivity graph: the normalised Laplacian's
  eigenvectors after the first, divided by the square-rooted degrees,
  with scikit-learn's deterministic sign flip;
- otherwise PCA to 2.

PCA is scikit-learn's: centred data, components from the covariance's
eigenvectors in float64, each signed so that its largest-magnitude entry
is positive (``svd_flip`` on the components).

The figure is a numpy raster PNG written through the port's codec, as the
port's ``evaluation/roc.py`` draws its plot (the card's machine has no
matplotlib): the points as discs in matplotlib's ``tab10`` colours at
alpha 0.8 on white, each label normalised to the labels' range as
``scatter(c=labels, cmap="tab10")`` maps it, a colour-bar strip to the
right, and no text.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.io import write_image

MACHINE_EPSILON = float(np.finfo(np.double).eps)
# matplotlib's tab10, RGB
TAB10 = np.array([
    (0x1F, 0x77, 0xB4), (0xFF, 0x7F, 0x0E), (0x2C, 0xA0, 0x2C),
    (0xD6, 0x27, 0x28), (0x94, 0x67, 0xBD), (0x8C, 0x56, 0x4B),
    (0xE3, 0x77, 0xC2), (0x7F, 0x7F, 0x7F), (0xBC, 0xBD, 0x22),
    (0x17, 0xBE, 0xCF)], np.float64)


def subsample(n: int, max_points: int, seed: int) -> np.ndarray | None:
    """The rows the JAX module keeps: None (all) up to ``max_points``."""
    if n <= max_points:
        return None
    return np.random.default_rng(seed).choice(n, max_points, replace=False)


def pca(x: torch.Tensor, n_components: int) -> torch.Tensor:
    """scikit-learn's ``PCA(n_components).fit_transform`` of (N, D) rows,
    in float64: the centred rows times the top components, each component
    signed so that its largest-magnitude entry is positive."""
    x = x.to(torch.float64)
    xc = x - x.mean(dim=0, keepdim=True)
    _, vecs = torch.linalg.eigh(xc.T @ xc)
    comps = torch.flip(vecs, dims=[1])[:, :n_components].T     # (k, D)
    big = comps.abs().argmax(dim=1)
    signs = torch.sign(comps.gather(1, big[:, None]))
    signs[signs == 0] = 1
    return xc @ (comps * signs).T


def _binary_search_perplexity(d2: torch.Tensor, perplexity: float,
                              steps: int = 100, tol: float = 1e-5
                              ) -> torch.Tensor:
    """scikit-learn's ``_binary_search_perplexity`` over all rows at once:
    each row's precision beta bisected (doubled or halved while unbounded)
    until the entropy of exp(-d2 * beta) is within ``tol`` of
    log(perplexity); the row's own term left out."""
    n = d2.shape[0]
    dev = d2.device
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    lo = torch.full_like(beta, -float("inf"))
    hi = torch.full_like(beta, float("inf"))
    live = torch.ones(n, dtype=torch.bool, device=dev)
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    want = float(np.log(perplexity))
    p = torch.zeros_like(d2)
    for _ in range(steps):
        pr = torch.exp(-d2 * beta[:, None]) * off
        s = pr.sum(dim=1)
        s = torch.where(s == 0, torch.full_like(s, 1e-8), s)
        pr = pr / s[:, None]
        p = torch.where(live[:, None], pr, p)
        h = torch.log(s) + beta * (d2 * pr).sum(dim=1)
        diff = h - want
        done = diff.abs() <= tol
        up = diff > 0
        new_beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2, (beta + hi) / 2),
            torch.where(torch.isinf(lo), beta / 2, (beta + lo) / 2))
        lo = torch.where(live & up & ~done, beta, lo)
        hi = torch.where(live & ~up & ~done, beta, hi)
        live = live & ~done
        beta = torch.where(live, new_beta, beta)
        if not bool(live.any()):
            break
    return p


def _kl_grad(y: torch.Tensor, p: torch.Tensor, compute_error: bool):
    """scikit-learn's ``_kl_divergence`` with one degree of freedom: the
    Student-t affinities Q, the KL divergence (when asked) and the
    gradient, (N, 2), in the embedding's dtype."""
    y64 = y.to(torch.float64)
    d = torch.cdist(y64, y64).square()
    w = 1.0 / (1.0 + d)
    w.fill_diagonal_(0.0)
    q = torch.clamp(w / w.sum(), min=MACHINE_EPSILON)
    err = None
    if compute_error:
        iu = torch.triu_indices(p.shape[0], p.shape[0], 1, device=p.device)
        pu, qu = p[iu[0], iu[1]], q[iu[0], iu[1]]
        err = float(2.0 * (pu * torch.log(
            torch.clamp(pu, min=MACHINE_EPSILON) / qu)).sum())
    pq = (p - q) * w
    pq.fill_diagonal_(0.0)
    grad = (pq.sum(dim=1, keepdim=True) * y64 - pq @ y64) * 4.0
    return err, grad.to(y.dtype)


def _gradient_descent(y, p, it, max_iter, momentum, lr,
                      n_iter_without_progress, check=50, min_gain=0.01,
                      min_grad_norm=1e-7):
    """scikit-learn's ``_gradient_descent``: gains and momentum start anew
    with each call; the update is float64 (the learning rate is a numpy
    float64), the embedding and the gains float32."""
    update = torch.zeros_like(y, dtype=torch.float64)
    gains = torch.ones_like(y)
    best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check_now = (i + 1) % check == 0
        err, grad = _kl_grad(y, p, check_now or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8)
        gains = torch.clamp(gains, min=min_gain)
        grad = grad * gains
        update = momentum * update - lr * grad.to(torch.float64)
        y = (y.to(update.dtype) + update).to(y.dtype)
        if check_now:
            grad_norm = float(torch.linalg.vector_norm(grad.to(torch.float64)))
            if err < best_error:
                best_error, best_iter = err, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= min_grad_norm:
                break
    return y, i


def joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """scikit-learn's ``_joint_probabilities`` as a full symmetric (N, N)
    float64 matrix (zero diagonal): the conditional affinities of the
    float32 squared distances, symmetrised, normalised to sum to 1 over
    the matrix, floored at machine epsilon."""
    x64 = x.to(torch.float32).to(torch.float64)
    d2 = torch.cdist(x64, x64).square().to(torch.float32).to(torch.float64)
    cond = _binary_search_perplexity(d2, perplexity)
    p = cond + cond.T
    p = torch.clamp(p / max(float(p.sum()), MACHINE_EPSILON),
                    min=MACHINE_EPSILON)
    return p.fill_diagonal_(0.0)


def kl_divergence(y, p: torch.Tensor) -> float:
    """The t-SNE objective of an (N, 2) map under ``joint_probabilities``."""
    y = torch.as_tensor(y, dtype=torch.float32, device=p.device)
    return _kl_grad(y, p, True)[0]


def tsne(x: torch.Tensor, perplexity: float, max_iter: int = 1000,
         early_exaggeration: float = 12.0) -> torch.Tensor:
    """Exact t-SNE of (N, D) rows to 2-D on scikit-learn's schedule (see
    the module note); float32 embedding, float64 affinities."""
    n = x.shape[0]
    pj = joint_probabilities(x, perplexity)
    y = pca(x.to(torch.float32), 2).to(torch.float32)
    y = y / torch.std(y[:, 0], correction=0) * 1e-4
    lr = max(n / early_exaggeration / 4.0, 50.0)
    explore = 250
    p_ex = pj * early_exaggeration
    y, it = _gradient_descent(y, p_ex, 0, explore, 0.5, lr, explore)
    if it < explore or max_iter - explore > 0:
        y, it = _gradient_descent(y, p_ex / early_exaggeration, it + 1,
                                  max_iter, 0.8, lr, 300)
    return y


def spectral_knn(x: torch.Tensor) -> torch.Tensor:
    """The JAX module's UMAP fallback (``_umap_2d``): the kNN connectivity
    graph (``max(2, min(15, n - 1))`` neighbours, self excluded),
    symmetrised as 0.5 (G + G^T), and its spectral embedding: the
    normalised Laplacian's eigenvectors 2 and 3 over the square-rooted
    degrees, each signed so its largest-magnitude entry is positive."""
    x = x.to(torch.float64)
    n = x.shape[0]
    k = max(2, min(15, n - 1))
    d = torch.cdist(x, x)
    d.fill_diagonal_(float("inf"))
    nbr = torch.topk(d, k, dim=1, largest=False).indices
    g = torch.zeros(n, n, dtype=torch.float64, device=x.device)
    g.scatter_(1, nbr, 1.0)
    a = 0.5 * (g + g.T)
    deg = a.sum(dim=1)
    dd = torch.sqrt(deg)
    lap = -a / dd[:, None] / dd[None, :]
    lap.fill_diagonal_(1.0)
    _, vecs = torch.linalg.eigh(lap)
    emb = (vecs[:, :3] / dd[:, None]).T                         # (3, n)
    big = emb.abs().argmax(dim=1)
    signs = torch.sign(emb.gather(1, big[:, None]))
    return (emb * signs)[1:3].T


def embed_2d(embeddings, method: str = "tsne", max_points: int = 3000,
             seed: int = 42, device=None) -> tuple[np.ndarray, np.ndarray]:
    """(the 2-D points (M, 2) float64, the kept rows' indices) as the JAX
    module computes them, before it draws."""
    x = np.asarray(embeddings)
    n = x.shape[0]
    idx = subsample(n, max_points, seed)
    keep = np.arange(n) if idx is None else idx
    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x[keep])).to(dev)
    if method == "tsne" and n > 5:
        if xt.shape[1] > 50:
            xt = pca(xt, 50).to(xt.dtype)
        perplexity = max(2, min(30, (xt.shape[0] - 1) // 3))
        pts = tsne(xt, perplexity)
    elif method == "umap" and n > 5:
        pts = spectral_knn(xt)
    else:
        pts = pca(xt, 2)
    return pts.detach().to(torch.float64).cpu().numpy(), keep


# --- the raster ---------------------------------------------------------------

_W, _H = 840, 720                 # matplotlib's 7 x 6 inches at 120 dpi
_PLOT = (60, 40, 660, 640)        # x0, y0, x1, y1 of the point area
_BAR = (700, 40, 724, 640)        # the colour-bar strip
_RADIUS = 2.4                     # s=8 points^2 at 120 dpi, in pixels
_ALPHA = 0.8


def label_colours(labels) -> np.ndarray:
    """(N, 3) RGB of each label as ``scatter(c=labels, cmap="tab10")``
    colours it: labels normalised to their range, tab10's 10 bins."""
    y = np.asarray(labels, np.float64)
    lo, hi = (y.min(), y.max()) if y.size else (0.0, 0.0)
    t = np.zeros_like(y) if hi == lo else (y - lo) / (hi - lo)
    i = np.clip((t * 10).astype(np.int64), 0, 9)
    return TAB10[i]


def point_pixels(pts: np.ndarray) -> np.ndarray:
    """(N, 2) pixel centres (x, y) of the points in the plot area: the data
    range with a 5% margin, y upward."""
    pts = np.asarray(pts, np.float64)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    lo, span = lo - 0.05 * span, span * 1.1
    x0, y0, x1, y1 = _PLOT
    u = (pts - lo) / span
    return np.stack([x0 + u[:, 0] * (x1 - x0), y1 - u[:, 1] * (y1 - y0)], 1)


def scatter_raster(pts: np.ndarray, labels) -> np.ndarray:
    """(H, W, 3) uint8 RGB: white, a grey frame round the plot area, each
    point a disc blended at alpha 0.8 in its label's colour (in order, the
    last on top), and the tab10 colour bar."""
    canvas = np.full((_H, _W, 3), 255.0)
    x0, y0, x1, y1 = _PLOT
    canvas[y0 - 1, x0 - 1:x1 + 2] = canvas[y1 + 1, x0 - 1:x1 + 2] = 0.0
    canvas[y0 - 1:y1 + 2, x0 - 1] = canvas[y0 - 1:y1 + 2, x1 + 1] = 0.0
    cols = label_colours(labels)
    r = int(np.ceil(_RADIUS))
    oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
    for (cx, cy), c in zip(point_pixels(pts), cols):
        px, py = int(round(cx)), int(round(cy))
        inside = (ox + (px - cx)) ** 2 + (oy + (py - cy)) ** 2 <= _RADIUS ** 2
        ys, xs = py + oy[inside], px + ox[inside]
        canvas[ys, xs] = canvas[ys, xs] * (1 - _ALPHA) + c * _ALPHA
    bx0, by0, bx1, by1 = _BAR
    rows = np.arange(by0, by1)
    band = np.minimum(((by1 - 1 - rows) * 10) // (by1 - by0), 9)
    canvas[by0:by1, bx0:bx1] = TAB10[band][:, None, :]
    return np.round(canvas).astype(np.uint8)


def visualize_embeddings(embeddings, labels, out_path: str | Path,
                         method: str = "tsne", max_points: int = 3000,
                         seed: int = 42, device=None) -> Path:
    pts, keep = embed_2d(embeddings, method, max_points, seed, device)
    y = np.asarray(labels)[keep]
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    write_image(out_path, scatter_raster(pts, y)[..., ::-1])
    return out_path
