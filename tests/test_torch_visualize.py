"""The port's two figures against the JAX package's: the orientation
overlay pixel for pixel (and the OpenCV drawing calls under it, bit for
bit), and the embedding scatter's 2-D reduction against scikit-learn.

Bounds stated here:

- PCA: within 1e-5 of ``sklearn.decomposition.PCA`` (float64 input), equal
  signs.
- Exact t-SNE: its joint probabilities within 1e-15 of scikit-learn's
  ``_joint_probabilities``; its first 5 gradient steps within 1e-6 of the
  embedding's scale of scikit-learn's ``_gradient_descent`` from the same
  start. After that the float32 embedding is chaotic: a one-ulp
  difference in a gradient sum (the port sums with a matrix product,
  scikit-learn row by row) grows about tenfold every two steps of early
  exaggeration, so the finished maps are compared by quality: final KL
  divergence within 5% of ``TSNE(method="exact")``'s (measured 0.9% on the
  200-point set below), trustworthiness (k=5) within 0.02 of scikit-learn's
  default Barnes-Hut t-SNE (measured 0.002).
- The spectral (UMAP fallback) embedding: within 1e-6 of the JAX
  package's ``_umap_2d`` on a connected kNN graph.
"""

import warnings

import cv2
import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu.classifier import (
    visualize as JV)
from multimodal_biometric_fingerprints_palms_tpu.preprocessing.visualize import (
    visualize_orientation as j_visualize_orientation)
from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (
    visualize as V)
from multimodal_biometric_fingerprints_palms_tpu_torch.ops.orientation import (
    compute_orientation_field)
from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.visualize import (
    visualize_orientation)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
    cvcompat, image_codec)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints)

torch.set_num_threads(1)
warnings.filterwarnings("ignore", category=FutureWarning)


# --- the OpenCV drawing calls -------------------------------------------------

@pytest.mark.parametrize("width", range(1, 41))
def test_line_aa_equals_opencv(width):
    """``cv2.line(..., 1, LINE_AA)`` on 1- and 3-channel images of every
    width from 1 to 40, end points inside and outside (clipped)."""
    rng = np.random.default_rng(width)
    for k in range(40):
        h = int(rng.integers(1, 41))
        ch = 3 if k % 2 else 1
        img = rng.integers(0, 256, (h, width, ch) if ch == 3 else (h, width),
                           dtype=np.uint8)
        p1 = tuple(int(v) for v in rng.integers(-12, 52, 2))
        p2 = tuple(int(v) for v in rng.integers(-12, 52, 2))
        col = tuple(int(v) for v in rng.integers(0, 256, ch))
        want = cv2.line(img.copy(), p1, p2, col, 1, cv2.LINE_AA)
        got = cvcompat.line_aa(img.copy(), p1, p2, col)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", range(1, 41))
def test_add_weighted_equals_opencv(width):
    """``cv2.addWeighted(a, 0.8, b, 0.2, 0)`` on uint8 rows of every width
    from 1 to 40 (every tail length of the vector loop), 3 channels, all
    65,536 value pairs laid across the rows."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8),
                       np.arange(256, dtype=np.uint8), indexing="ij")
    n = -(-65536 // (3 * width)) * 3 * width
    a = np.resize(a.ravel(), n).reshape(-1, width, 3)
    b = np.resize(b.ravel()[::-1], n).reshape(-1, width, 3)
    np.testing.assert_array_equal(cvcompat.add_weighted(a, 0.8, b, 0.2, 0),
                                  cv2.addWeighted(a, 0.8, b, 0.2, 0))


# --- the orientation overlay ---------------------------------------------------

@pytest.fixture(scope="module")
def field():
    img = blob_prints([4], None, 160, 128)[0].astype(np.float32)
    res = compute_orientation_field(torch.from_numpy(img)[None])
    orient = res.orientation[0].numpy()
    rel = res.reliability[0].numpy()
    mask = img > 0.3
    return img, orient, rel, mask


@pytest.mark.parametrize("case", ["float, gated", "uint8, gated",
                                  "no gates", "block 8, scale 5, green",
                                  "tensors"])
def test_visualize_orientation_equals_jax(field, case):
    """The port's overlay is the JAX function's, pixel for pixel, on an
    orientation field the port computes on the CPU."""
    img, orient, rel, mask = field
    kw = dict(reliability_img=rel, mask=mask)
    x = img
    if case == "uint8, gated":
        x = np.round(img * 255).astype(np.uint8)
    elif case == "no gates":
        kw = {}
    elif case == "block 8, scale 5, green":
        kw.update(block_size=8, scale=5, color=(0, 200, 40), rel_thresh=0.4)
    want = j_visualize_orientation(x, orient, **kw)
    if case == "tensors":
        got = visualize_orientation(torch.from_numpy(x),
                                    torch.from_numpy(orient),
                                    reliability_img=torch.from_numpy(rel),
                                    mask=torch.from_numpy(mask))
    else:
        got = visualize_orientation(x, orient, **kw)
    assert got.dtype == np.uint8 and got.shape == img.shape + (3,)
    np.testing.assert_array_equal(got, want)


# --- the embedding reduction ---------------------------------------------------

def _clusters(n=200, d=64, sep=4.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, sep, (6, d))
    lab = rng.integers(0, 6, n)
    return (centers[lab] + rng.normal(0, 1, (n, d))).astype(np.float32), lab


@pytest.mark.parametrize("shape,k", [((150, 80), 50), ((200, 256), 50),
                                     ((3000, 64), 50), ((5, 256), 2),
                                     ((40, 3), 2)])
def test_pca_equals_sklearn(shape, k):
    from sklearn.decomposition import PCA
    rng = np.random.default_rng(shape[0])
    x = rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1]))
    want = PCA(n_components=k, random_state=42).fit_transform(x)
    got = V.pca(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    big = np.abs(want).argmax(axis=0)
    assert (np.sign(got[big, range(k)]) == np.sign(want[big, range(k)])).all()


def test_tsne_probabilities_equal_sklearn():
    from sklearn.manifold import _t_sne as T
    from sklearn.metrics import pairwise_distances
    from scipy.spatial.distance import squareform
    x, _ = _clusters()
    want = T._joint_probabilities(pairwise_distances(x, squared=True), 66, 0)
    pj = V.joint_probabilities(torch.from_numpy(x), 66)
    np.testing.assert_allclose(squareform(pj.numpy(), checks=False), want,
                               rtol=0, atol=1e-15)


def test_tsne_first_steps_equal_sklearn():
    """Five steps of early exaggeration from one start: scikit-learn's
    ``_gradient_descent`` and the port's, within 1e-6 of the scale."""
    from sklearn.manifold import _t_sne as T
    from sklearn.metrics import pairwise_distances
    from scipy.spatial.distance import squareform
    x, _ = _clusters()
    n = x.shape[0]
    p = T._joint_probabilities(pairwise_distances(x, squared=True), 66, 0)
    init = (np.random.default_rng(1).normal(size=(n, 2)) * 1e-4).astype(
        np.float32)
    lr = np.maximum(n / 12 / 4, 50)
    want, _, _ = T._gradient_descent(
        T._kl_divergence, init.ravel().copy(), 0, 5, n_iter_check=50,
        momentum=0.5, learning_rate=lr, args=[p * 12.0, 1, n, 2], kwargs={},
        n_iter_without_progress=250)
    got, _ = V._gradient_descent(torch.from_numpy(init.copy()),
                                 torch.from_numpy(squareform(p * 12.0)), 0, 5,
                                 0.5, float(lr), 250)
    want = want.reshape(n, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.fixture(scope="module")
def tsne_maps():
    from sklearn.manifold import TSNE
    x, _ = _clusters()
    per = max(2, min(30, (x.shape[0] - 1) // 3))
    exact = TSNE(2, perplexity=per, random_state=42, init="pca",
                 method="exact")
    e = exact.fit_transform(x)
    bh = TSNE(2, perplexity=per, random_state=42, init="pca").fit_transform(x)
    port = V.tsne(torch.from_numpy(x), per).numpy()
    return x, per, exact.kl_divergence_, e, bh, port


def test_tsne_reaches_sklearns_divergence(tsne_maps):
    from sklearn.manifold import _t_sne as T
    from sklearn.metrics import pairwise_distances
    x, per, kl_exact, _, _, port = tsne_maps
    p = T._joint_probabilities(pairwise_distances(x, squared=True), per, 0)
    kl_port = T._kl_divergence(port.ravel(), p, 1, x.shape[0], 2)[0]
    assert abs(kl_port - kl_exact) <= 0.05 * kl_exact
    # the port's own objective reads the same divergence
    pj = V.joint_probabilities(torch.from_numpy(x), per)
    assert abs(V.kl_divergence(port, pj) - kl_port) <= 1e-9 * kl_port


def test_tsne_trustworthiness_near_barnes_hut(tsne_maps):
    from sklearn.manifold import trustworthiness
    x, _, _, _, bh, port = tsne_maps
    assert abs(trustworthiness(x, port, n_neighbors=5)
               - trustworthiness(x, bh, n_neighbors=5)) <= 0.02


@pytest.mark.parametrize("n", [60, 200])
def test_spectral_embedding_equals_jax_fallback(n):
    """A noisy spiral: its kNN graph is connected, so the Laplacian's
    second and third eigenvectors are unique up to sign."""
    rng = np.random.default_rng(n)
    t = np.linspace(0, 6, n)
    x = np.stack([np.cos(t) * t, np.sin(t) * t]
                 + [rng.normal(0, 0.05, n) for _ in range(6)], 1).astype(
        np.float32)
    want = JV._umap_2d(x, 42)
    got = V.spectral_knn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,max_points", [(50, 3000), (500, 120),
                                          (3001, 3000)])
def test_subsample_indices_equal_jax(n, max_points, monkeypatch, tmp_path):
    """The JAX module's rows: ``default_rng(seed).choice`` above
    ``max_points``, all rows below. The JAX function's kept rows are read
    off the PCA it is handed."""
    seen = {}

    class Spy:
        def __init__(self, *a, **k):
            pass

        def fit_transform(self, x):
            seen["x"] = x
            return np.zeros((x.shape[0], 2))

    import sklearn.decomposition
    monkeypatch.setattr(sklearn.decomposition, "PCA", Spy)
    x = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
    pytest.importorskip("matplotlib")
    JV.visualize_embeddings(x, np.zeros(n), tmp_path / "f.png", method="pca",
                            max_points=max_points, seed=7)
    _, keep = V.embed_2d(x, "pca", max_points, 7, device="cpu")
    np.testing.assert_array_equal(keep, seen["x"][:, 0].astype(np.int64))


@pytest.mark.parametrize("method", ["tsne", "umap", "pca"])
def test_small_sets_take_pca_as_the_jax_module_does(method):
    """Five points or fewer: PCA to 2 whatever the method."""
    from sklearn.decomposition import PCA
    x = np.random.default_rng(3).normal(size=(5, 12))
    pts, _ = V.embed_2d(x, method, device="cpu")
    np.testing.assert_allclose(pts, PCA(2).fit_transform(x), atol=1e-10)


def test_figure_holds_each_point_in_its_colour(tmp_path):
    """The PNG written: the tab10 colour of each label (normalised to the
    labels' range, as ``scatter(c=labels, cmap="tab10")``) at the pixel the
    point's coordinates map to, blended at alpha 0.8 on white; the frame
    and the colour bar's ten bands."""
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0],
                    [0.5, 0.5]])
    labels = np.array([3, 7, 5, 11, 9])
    out = V.visualize_embeddings(pts, labels, tmp_path / "f" / "e.png",
                                 method="pca", device="cpu")
    rgb = image_codec.read_rgb(out)
    assert rgb.shape == (720, 840, 3)
    raster = V.scatter_raster(V.embed_2d(pts, "pca", device="cpu")[0],
                              labels)
    np.testing.assert_array_equal(rgb, raster)
    # the colours, at the points' own pixels (a map of the raw points)
    raster = V.scatter_raster(pts, labels)
    want = V.label_colours(labels)
    assert (want[0] == V.TAB10[0]).all() and (want[3] == V.TAB10[9]).all()
    for (x, y), c in zip(V.point_pixels(pts), want):
        px = raster[int(round(y)), int(round(x))].astype(np.float64)
        np.testing.assert_array_equal(px, np.round(255 * 0.2 + c * 0.8))
    assert (raster[0, 0] == 255).all()
    bar = raster[40:640, 712]
    assert len({tuple(v) for v in bar.tolist()}) == 10
