"""The port's PRNG draws and clustering against the JAX package's: threefry
``split``, ``random_bits``, ``uniform`` from derived keys, ``randint`` and
``categorical`` bit-equal to ``jax.random``; kmeans++ seeds, kmeans labels
(inertia within 1e-5 relative), agglomerative labels, PCA up to sign and
the three quality metrics (within 1e-5) on separated blobs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu import clustering as J
from multimodal_biometric_fingerprints_palms_tpu.clustering.agglomerative import (
    _merge_centers as j_merge)
from multimodal_biometric_fingerprints_palms_tpu_torch import clustering as T
from multimodal_biometric_fingerprints_palms_tpu_torch.clustering.agglomerative import (
    _merge_centers as t_merge)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 + 5, 2 ** 32 - 1]


def blobs(seed, n_per=40, k=8, d=16, spread=5.0):
    g = np.random.default_rng(seed)
    centers = g.normal(0, spread, (k, d))
    x = np.concatenate([c + g.normal(0, 1, (n_per, d)) for c in centers])
    return x[g.permutation(len(x))].astype(np.float32)


def row_index(x, rows):
    return [int(np.nonzero((x == r).all(axis=1))[0][0]) for r in rows]


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_bits_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    for num in (2, 5):
        want = [tuple(map(int, r)) for r in
                np.asarray(jax.random.key_data(jax.random.split(k, num)))]
        assert threefry.split(threefry.key(seed), num) == want
    for jk, tk in zip(jax.random.split(k), threefry.split(threefry.key(seed))):
        for shape in ((), (7,), (3, 5)):
            np.testing.assert_array_equal(
                threefry.random_bits(tk, shape),
                np.asarray(jax.random.bits(jk, shape, jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_from_a_derived_key_matches_jax(seed):
    """Including ranges whose scaling XLA fuses into a multiply-add."""
    jk = jax.random.split(jax.random.PRNGKey(seed))[1]
    tk = threefry.split(threefry.key(seed))[1]
    tiny = float(np.finfo(np.float32).tiny)
    for shape in ((), (9,), (4, 1024)):
        for lo, hi in ((0.0, 1.0), (-2.5, 3.7), (tiny, 1.0), (1e-3, 7e5)):
            np.testing.assert_array_equal(
                threefry.uniform_from(tk, shape, lo, hi),
                np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed):
    jk = jax.random.split(jax.random.PRNGKey(seed))[0]
    tk = threefry.split(threefry.key(seed))[0]
    for shape in ((), (11,), (2, 3)):
        for lo, hi in ((0, 10), (0, 1480), (-5, 100000), (3, 3), (7, 2),
                       (0, 2 ** 31 - 1)):
            np.testing.assert_array_equal(
                threefry.randint(tk, shape, lo, hi),
                np.asarray(jax.random.randint(jk, shape, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    """The Gumbel-max index on random and on kmeans++-like logits (many
    entries at log(1e-30))."""
    jk, tk = jax.random.PRNGKey(seed), threefry.key(seed)
    for n in (5, 100, 1480):
        for trial in range(3):
            jk, jsub = jax.random.split(jk)
            tk, tsub = threefry.split(tk)
            p = np.random.default_rng(seed % 1000 + n + trial).random(n)
            p[p < 0.3] = 0.0
            p = (p / p.sum()).astype(np.float32)
            logits = np.log(np.maximum(p, np.float32(1e-30))).astype(np.float32)
            assert threefry.categorical(tsub, logits) == int(
                jax.random.categorical(jsub, jnp.asarray(logits)))


def test_gumbel_noise_within_an_ulp_of_jax():
    """XLA's float32 log is its own approximation: the noise agrees within
    a few ulps, the uniforms under it bit for bit."""
    jk, tk = jax.random.PRNGKey(3), threefry.key(3)
    want = np.asarray(jax.random.gumbel(jk, (4096,), jnp.float32))
    got = threefry.gumbel(tk, (4096,))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("seed", [0, 42, 7])
def test_kmeans_plus_plus_seeds_match_jax(seed):
    x = blobs(seed)
    want = np.asarray(J.kmeans_plus_plus_init(jax.random.PRNGKey(seed),
                                              jnp.asarray(x), 8))
    got = T.kmeans_plus_plus_init(threefry.key(seed), x, 8, device="cpu").numpy()
    assert row_index(x, got) == row_index(x, want)


@pytest.mark.parametrize("seed", [0, 42, 7])
def test_kmeans_matches_jax(seed):
    x = blobs(seed)
    jl, jc, ji = J.kmeans(jax.random.PRNGKey(seed), jnp.asarray(x), 8)
    tl, tc, ti = T.kmeans(threefry.key(seed), torch.from_numpy(x), 8,
                          device="cpu")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    assert abs(float(ti) - float(ji)) <= 1e-5 * abs(float(ji))


@pytest.mark.parametrize("seed", [0, 3])
def test_agglomerative_matches_jax(seed):
    """Two stages: kmeans to 64 centres, 56 merges; and the merge loop
    alone on 48 JAX-chosen centres."""
    x = blobs(seed)
    want = np.asarray(J.agglomerative_fast(jax.random.PRNGKey(seed),
                                           jnp.asarray(x), 8, max_centers=64))
    got = T.agglomerative_fast(threefry.key(seed), x, 8, max_centers=64,
                               device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    centers = blobs(seed + 10, n_per=6, k=8, d=12)
    np.testing.assert_array_equal(
        t_merge(torch.from_numpy(centers), 5).numpy(),
        np.asarray(j_merge(jnp.asarray(centers), 5)))


def test_agglomerative_falls_back_to_kmeans_when_few_points():
    x = blobs(5, n_per=1, k=6)
    want = np.asarray(J.agglomerative_fast(jax.random.PRNGKey(1),
                                           jnp.asarray(x), 8))
    got = T.agglomerative_fast(threefry.key(1), x, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_pca_matches_jax_up_to_sign():
    """A separated spectrum (variances 10^2 .. 1): components, variances
    and the projection agree up to each component's sign."""
    g = np.random.default_rng(4)
    scales = np.geomspace(10.0, 1.0, 12)
    x = (g.normal(size=(300, 12)) * scales) @ np.linalg.qr(
        g.normal(size=(12, 12)))[0]
    x = x.astype(np.float32)
    jr, jc, jv = (np.asarray(a) for a in J.pca_reduce(jnp.asarray(x), 5))
    tr, tc, tv = (a.numpy() for a in T.pca_reduce(torch.from_numpy(x), 5,
                                                   device="cpu"))
    sign = np.sign(np.sum(jc * tc, axis=1))
    assert np.all(np.abs(sign) == 1)
    np.testing.assert_allclose(tc * sign[:, None], jc, atol=1e-4)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tr * sign, jr, atol=1e-3)


@pytest.mark.parametrize("metric", ["silhouette_score_cosine",
                                    "davies_bouldin_index",
                                    "calinski_harabasz_index"])
@pytest.mark.parametrize("empty", [False, True])
def test_metrics_match_jax(metric, empty):
    """Within 1e-5 relative; ``empty`` leaves cluster 8 of 9 unused (the
    JAX functions' quirks for it are kept)."""
    x = blobs(11)
    labels = np.asarray(J.kmeans(jax.random.PRNGKey(0), jnp.asarray(x), 8)[0])
    c = 9 if empty else 8
    want = float(getattr(J, metric)(jnp.asarray(x), jnp.asarray(labels), c))
    got = float(getattr(T, metric)(torch.from_numpy(x),
                                   torch.from_numpy(labels.copy()), c,
                                   device="cpu"))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("max_points", [5000, 100])
def test_evaluate_clustering_matches_jax(max_points):
    """The report, including the ``default_rng(seed).choice`` subsample."""
    x = blobs(12)
    labels = np.asarray(J.kmeans(jax.random.PRNGKey(1), jnp.asarray(x), 8)[0])
    want = J.evaluate_clustering(x, labels, 8, max_points=max_points, seed=3)
    got = T.evaluate_clustering(x, labels, 8, max_points=max_points, seed=3,
                                device="cpu")
    assert set(got) == set(want)
    for k in ("cluster_sizes", "n_samples", "embedding_stats"):
        assert got[k] == want[k], k
    for k in ("silhouette_cosine", "davies_bouldin", "calinski_harabasz"):
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
