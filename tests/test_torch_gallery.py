"""Parity of the port's gallery (``parallel/``) with the JAX package's on the
CPU.

Galleries are jittered constellations (the generator of
``tests/test_eval_parallel.py``, copied here), made from numpy seeds and
handed to both packages. The JAX functions run with ``use_pallas=False``
on the 8-device CPU mesh of ``tests/conftest.py``; the port runs on a CPU
mesh, where kernel D's plain twin scores. Tolerances, with their reasons:

- unique pairs, padding, template gathers, promote masks, slot mapping:
  exact (integer or copied values).
- final scores against the JAX package's XLA route: 1e-4, the bound
  ``PERF.md`` section 2 states for the port's one route against it.
- promote masks: the JAX package's CPU route screens with the full matcher,
  so the port's blocked screen is held to the accelerator rule composed on
  the CPU, ``screen_pairs_batch_pallas(interpret=True) | anchor_promote``,
  on the pair list the block layout decodes to.

The cascade and mask cases use K=16 templates (all 16 minutiae valid): a
screen tile is 4,096 pairs, and the plain twin's float64 temporaries grow
with K * K.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu.features.minutiae import (
    MinutiaeSet as JSet)
from multimodal_biometric_fingerprints_palms_tpu.matching import (
    pallas_match as jpm, ransac as jr)
from multimodal_biometric_fingerprints_palms_tpu.parallel import (
    gallery as jg, mesh as jmesh)
from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
    MinutiaeSet as TSet, minutiae_from_numpy)
from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
    ransac as tr)
from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
    gallery as tg, mesh as tmesh)

torch.set_num_threads(1)

SCORE_ATOL = 1e-4


def _gallery(rng, n_users, samples_per_user, k=64):
    """Each user a random constellation of 16 minutiae; its samples are
    jittered copies (1 px). Returns numpy fields and the user labels."""
    fields = {f: [] for f in JSet._fields}
    for u in range(n_users):
        g = np.random.default_rng(1000 + u)
        n = 16
        base_xy = g.random((n, 2)).astype(np.float32) * 120 + 60
        base_ori = (g.random(n).astype(np.float32) - 0.5) * np.pi
        types = (g.random(n) > 0.5).astype(np.int32)
        q = 0.6 + 0.4 * g.random(n).astype(np.float32)
        for _ in range(samples_per_user):
            jit_xy = base_xy + rng.normal(0, 1.0, (n, 2)).astype(np.float32)
            xy = np.zeros((k, 2), np.float32); xy[:n] = jit_xy
            ori = np.zeros((k,), np.float32); ori[:n] = base_ori
            ty = np.zeros((k,), np.int32); ty[:n] = types
            qq = np.zeros((k,), np.float32); qq[:n] = q
            valid = np.zeros((k,), bool); valid[:n] = True
            for f, v in zip(JSet._fields, (xy, ty, ori, qq, qq, qq, valid)):
                fields[f].append(v)
    stacked = {f: np.stack(v) for f, v in fields.items()}
    return stacked, np.repeat(np.arange(n_users), samples_per_user)


def _both(d: dict):
    """A numpy template batch as a JAX and a port MinutiaeSet."""
    return (JSet(**{f: jnp.asarray(v) for f, v in d.items()}),
            minutiae_from_numpy(d))


def _params(**kw):
    return jr.MatchParams(**kw), tr.MatchParams(**kw)


@functools.cache
def _jax_mesh():
    return jmesh.create_mesh(8)


def _cpu():
    return tmesh.create_mesh(device="cpu")


def _np(x):
    return np.asarray(x)


# --- the mesh ---------------------------------------------------------------

def test_create_mesh_is_one_device_and_the_card_by_default():
    mesh = _cpu()
    assert mesh.size == 1 and mesh.devices == (torch.device("cpu"),)
    assert mesh.axis_name == "gallery"
    assert tmesh.gallery_sharding(mesh) == (torch.device("cpu"), "gallery")
    assert tmesh.replicated(mesh) == (torch.device("cpu"), None)
    assert tmesh.create_mesh(1, "rows", device="cpu").axis_name == "rows"
    for n in (2, 8):        # more devices: ranks of a process group
        with pytest.raises(ValueError, match="run_ranks"):
            tmesh.create_mesh(n, device="cpu")
    with pytest.raises(ValueError):
        tmesh.create_mesh(0, device="cpu")
    if torch.cuda.is_available():
        assert tmesh.create_mesh(1).devices[0].type == "cuda"
        return
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.create_mesh(device=device)


def test_shard_gallery_moves_every_field_to_the_mesh_device():
    d, _ = _gallery(np.random.default_rng(0), 2, 2)
    ms = tg.shard_gallery(minutiae_from_numpy(d), _cpu())
    assert isinstance(ms, TSet)
    for f, x in zip(TSet._fields, ms):
        assert x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), d[f])


_MESH_CALLS = {
    "all_pairs_scores": lambda g, m, p: tg.all_pairs_scores(
        g, m, p, col_chunk=4),
    "shard_pairs_scores": lambda g, m, p: tg.shard_pairs_scores(
        g, tg.unique_pairs(4), m, p),
    "shard_pairs_screen": lambda g, m, p: tg.shard_pairs_screen(
        g, tg.unique_pairs(4), m, p),
    "shard_blocks_screen": lambda g, m, p: tg.shard_blocks_screen(
        g, m, p, block=2),
    "all_pairs_unique": lambda g, m, p: tg.all_pairs_unique(
        g, m, p, cascade=False),
    "all_pairs_unique cascade": lambda g, m, p: tg.all_pairs_unique(
        g, m, p, cascade=True, screen_iters=8),
    "identify": lambda g, m, p: tg.identify(
        TSet(*(x[0] for x in g)), g, m, p, chunk=2),
    "identify_batch": lambda g, m, p: tg.identify_batch(
        TSet(*(x[:3] for x in g)), g, m, p, chunk=2),
}


@pytest.mark.parametrize("entry", sorted(_MESH_CALLS))
def test_the_mesh_decides_where_the_matcher_runs(entry, monkeypatch):
    """A gallery (and probes) built on the CPU and handed a mesh of another
    device are matched on the mesh's device. The mesh here is the meta
    device, which every gather accepts; the matcher is replaced by a stub
    that records its inputs' devices."""
    seen = []

    def full(a, b, params):
        seen.extend({a.valid.device, b.valid.device, *(x.device for x in a)})
        n = a.valid.shape[0]
        return tr.MatchResult(*(torch.zeros(n) for _ in tr.MatchResult._fields))

    def screen(a, b, params, anchors=True):
        seen.extend({a.valid.device, b.valid.device, *(x.device for x in b)})
        return torch.ones(a.valid.shape[0], dtype=torch.bool)

    monkeypatch.setattr(tg, "match_pairs_batch", full)
    monkeypatch.setattr(tg, "screen_promote_batch", screen)
    d, _ = _gallery(np.random.default_rng(0), 2, 2)
    meta = tmesh.Mesh((torch.device("meta"),), "gallery")
    _MESH_CALLS[entry](minutiae_from_numpy(d), meta,
                       tr.MatchParams(ransac_iter=16))
    assert seen and set(seen) == {torch.device("meta")}


# --- numpy helpers and gathers ----------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 7, 70])
def test_unique_pairs_equal(n):
    got, ref = tg.unique_pairs(n), jg.unique_pairs(n)
    assert got.dtype == ref.dtype and got.shape == (n * (n - 1) // 2, 2)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("multiple", [1, 8, 64])
def test_pad_gallery_equal(multiple, rng):
    d, _ = _gallery(rng, 2, 5)                          # N=10
    jset, tset = _both(d)
    ref, got = jg.pad_gallery(jset, multiple), tg.pad_gallery(tset, multiple)
    for f, x, y in zip(TSet._fields, got, ref):
        assert x.shape[0] == -(-10 // multiple) * multiple, f
        assert x.numpy().dtype == _np(y).dtype, f
        np.testing.assert_array_equal(x.numpy(), _np(y))
    assert not got.valid[10:].any()


def test_take_templates_equals_the_one_hot_gather(rng):
    d, _ = _gallery(rng, 3, 4)
    jset, tset = _both(d)
    idx = np.array([11, 0, 3, 3, 7, 0, 11, 5], np.int32)
    ref = jg.take_templates(jset, jnp.asarray(idx))
    got = tg.take_templates(tset, idx)
    for f, x, y in zip(TSet._fields, got, ref):
        assert x.numpy().dtype == _np(y).dtype, f
        np.testing.assert_array_equal(x.numpy(), _np(y))
    same = tg.take_templates(tset, torch.from_numpy(idx.astype(np.int64)))
    assert all(torch.equal(x, y) for x, y in zip(same, got))


# --- scores against the XLA route -------------------------------------------

def test_all_pairs_scores_matches_jax(rng):
    d, labels = _gallery(rng, 4, 4)                     # N=16, K=64
    jset, tset = _both(d)
    jp, tp = _params(ransac_iter=16, min_inliers=5)
    mesh = _jax_mesh()
    ref = _np(jg.all_pairs_scores(jg.shard_gallery(jset, mesh), mesh, jp,
                                  col_chunk=16))
    got = tg.all_pairs_scores(tset, _cpu(), tp, col_chunk=16)
    assert got.shape == (16, 16) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), ref, atol=SCORE_ATOL)
    same = labels[:, None] == labels[None, :]
    off_diag = ~np.eye(16, dtype=bool)
    scores = got.numpy()
    assert scores[same & off_diag].mean() > scores[~same].mean() + 0.2
    # a column chunk smaller than N gives the same matrix
    np.testing.assert_array_equal(
        tg.all_pairs_scores(tset, _cpu(), tp, col_chunk=8).numpy(), scores)


def test_all_pairs_scores_checks_the_column_chunk(rng):
    d, _ = _gallery(rng, 4, 4)
    with pytest.raises(ValueError, match="col_chunk"):
        tg.all_pairs_scores(minutiae_from_numpy(d), _cpu(), col_chunk=6)


@functools.cache
def _n70():
    """N=70 (14 users x 5, K=16): two 64-template blocks, the second
    padded; the port's cascade-off scores of every unique pair."""
    d, labels = _gallery(np.random.default_rng(42), 14, 5, k=16)
    _, tp = _params(ransac_iter=16, min_inliers=5)
    off = tg.all_pairs_unique(minutiae_from_numpy(d), _cpu(), tp, chunk=512,
                              cascade=False)
    return d, labels, off


def test_all_pairs_unique_without_cascade_matches_jax():
    d, labels, got = _n70()
    jset, _ = _both(d)
    jp, _ = _params(ransac_iter=16, min_inliers=5)
    ref = jg.all_pairs_unique(jset, _jax_mesh(), jp, chunk=512, cascade=False,
                              use_pallas=False)
    pairs = tg.unique_pairs(70)
    assert got.dtype == np.float64 and got.shape == (pairs.shape[0],)
    np.testing.assert_allclose(got, ref, atol=SCORE_ATOL)
    same = labels[pairs[:, 0]] == labels[pairs[:, 1]]
    assert got[same].mean() > got[~same].mean() + 0.2


def test_all_pairs_unique_cascade_fills_exactly_the_promoted_slots():
    """The blocked screen's promote bits, mapped back to unique-pair slots,
    equal the pair-list screen's on ``unique_pairs(N)``, and the cascade's
    scores are the full pass's there and 0 elsewhere."""
    d, labels, off = _n70()
    tset = minutiae_from_numpy(d)
    _, tp = _params(ransac_iter=16, min_inliers=5)
    got = tg.all_pairs_unique(tset, _cpu(), tp, chunk=512, cascade=True,
                              screen_iters=4)
    screen_p = tp._replace(ransac_iter=4, full_iters=16, min_inliers=3)
    pairs = tg.unique_pairs(70)
    promoted = tg.shard_pairs_screen(tset, pairs, _cpu(), screen_p, chunk=512)
    assert 0 < promoted.sum() < promoted.size
    np.testing.assert_array_equal(got, np.where(promoted, off, 0.0))
    same = labels[pairs[:, 0]] == labels[pairs[:, 1]]
    assert got[same].mean() > got[~same].mean() + 0.2


@functools.cache
def _mask_case():
    """24 templates (6 users x 4, K=16) screened in 16-template blocks: two
    blocks, three block pairs, 768 pairs with padding; the decoded pair
    list and the JAX accelerator rule's two halves on it."""
    d, _ = _gallery(np.random.default_rng(7), 6, 4, k=16)
    jset, tset = _both(d)
    jp, tp = _params(ransac_iter=8, full_iters=64, min_inliers=3)
    block = 16
    bp, _ = tg.shard_blocks_screen(tset, _cpu(), tp, block=block,
                                   anchors=False)
    assert len(bp) == 3
    il, jl = np.divmod(np.arange(block * block), block)
    ia = (bp[:, :1] * block + il[None]).ravel()
    ib = (bp[:, 1:] * block + jl[None]).ravel()
    gpad = jg.pad_gallery(jset, block)
    take = lambda idx: jax.tree.map(lambda x: x[idx], gpad)
    base = _np(jpm.screen_pairs_batch_pallas(take(ia), take(ib), jp,
                                             interpret=True))
    anchors = _np(jax.vmap(lambda x, y: jr.anchor_promote(x, y, jp))(
        take(ia), take(ib)))
    return (tset, tg.pad_gallery(tset, block), tp, block, bp,
            np.stack([ia, ib], axis=1), base, anchors)


@pytest.mark.parametrize("anchors", [True, False])
def test_blocks_screen_mask_matches_the_accelerator_rule(anchors):
    tset, tpad, tp, block, bp, pairs, base, anc = _mask_case()
    ref = base | anc if anchors else base
    got_bp, mask = tg.shard_blocks_screen(tset, _cpu(), tp, block=block,
                                          anchors=anchors)
    np.testing.assert_array_equal(got_bp, [[0, 0], [0, 1], [1, 1]])
    np.testing.assert_array_equal(bp, got_bp)
    assert mask.shape == (3, block * block) and mask.dtype == bool
    np.testing.assert_array_equal(mask.ravel(), ref)
    # the pair-list screen gives the same bits in any chunking
    np.testing.assert_array_equal(
        tg.shard_pairs_screen(tpad, pairs, _cpu(), tp, chunk=100,
                              anchors=anchors), ref)
    assert 0 < ref.sum() < ref.size
    assert (anc & ~base).any()          # the anchors promote pairs of their own


# --- identification ---------------------------------------------------------

@functools.cache
def _identify_case():
    d, labels = _gallery(np.random.default_rng(42), 4, 4)    # N=16, K=64
    jset, tset = _both(d)
    jp, tp = _params(ransac_iter=16, min_inliers=5)
    return d, labels, jset, tset, jp, tp


def test_identify_matches_jax():
    _, labels, jset, tset, jp, tp = _identify_case()
    mesh = _jax_mesh()
    for i in (1, 6, 13):
        jprobe = jax.tree.map(lambda x: x[i], jset)
        ref = _np(jg.identify(jprobe, jg.shard_gallery(jset, mesh), mesh, jp,
                              use_pallas=False))
        got = tg.identify(TSet(*(x[i] for x in tset)), tset, _cpu(), tp)
        assert got.shape == (16,) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), ref, atol=SCORE_ATOL)
        assert int(got.argmax()) == int(np.argmax(ref))
        others = got.numpy().copy()
        others[i] = -1.0
        assert labels[int(np.argmax(others))] == labels[i]


def test_identify_batch_matches_jax_and_identify():
    _, labels, jset, tset, jp, tp = _identify_case()
    mesh = _jax_mesh()
    idx = np.array([1, 5, 9, 14])
    ref = _np(jg.identify_batch(jax.tree.map(lambda x: x[idx], jset),
                                jg.shard_gallery(jset, mesh), mesh, jp,
                                use_pallas=False))
    probes = tg.take_templates(tset, idx)
    got = tg.identify_batch(probes, tset, _cpu(), tp, chunk=8)
    assert got.shape == (4, 16)
    np.testing.assert_allclose(got.numpy(), ref, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got.argmax(dim=1).numpy(),
                                  np.argmax(ref, axis=1))
    for row, i in enumerate(idx):
        one = tg.identify(TSet(*(x[i] for x in tset)), tset, _cpu(), tp,
                          chunk=4)
        np.testing.assert_array_equal(one.numpy(), got[row].numpy())


def test_identify_checks_the_chunk():
    _, _, _, tset, _, tp = _identify_case()
    probe = TSet(*(x[0] for x in tset))
    with pytest.raises(ValueError, match="chunk"):
        tg.identify(probe, tset, _cpu(), tp, chunk=6)
    with pytest.raises(ValueError, match="chunk"):
        tg.identify_batch(tg.take_templates(tset, [0, 1]), tset, _cpu(), tp,
                          chunk=5)
