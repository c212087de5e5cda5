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

``identify_batch``'s cascade and candidate list are held to the
benchmark's frozen plain reference (``cudabench/reference/candidates.py``,
plain PyTorch of its own): ids exact, scores within 1e-6; its defaults to
the full pass of every pair, bit for bit.
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
    cuda_match as tcm, ransac as tr)
from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
    gallery as tg, launch, mesh as tmesh)

from cudabench.reference import candidates as rc, match as rm
from torch_card import card  # noqa: F401  (a fixture)

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


@pytest.mark.parametrize("tiles_a_call", [1, 2])
def test_blocks_screen_mask_does_not_depend_on_the_tiles_a_call(
        monkeypatch, tiles_a_call):
    """The blocked screen takes whole tiles, up to ``_SCREEN_PAIRS`` pairs,
    a ``screen_promote_batch`` call (all three tiles of the case in one call
    at the default); at one and at two tiles a call it makes three and two
    calls, the last one short, and gives the same mask."""
    tset, _, tp, block, _, _, base, anc = _mask_case()
    shipped, sizes = tg.screen_promote_batch, []

    def spy(a, b, p, anchors):
        sizes.append(a.valid.shape[0])
        return shipped(a, b, p, anchors)

    monkeypatch.setattr(tg, "screen_promote_batch", spy)
    tg.shard_blocks_screen(tset, _cpu(), tp, block=block)
    assert sizes == [3 * block * block]
    monkeypatch.setattr(tg, "_SCREEN_PAIRS", tiles_a_call * block * block)
    sizes.clear()
    _, mask = tg.shard_blocks_screen(tset, _cpu(), tp, block=block)
    want = ([block * block] * 3 if tiles_a_call == 1
            else [2 * block * block, block * block])
    assert sizes == want
    np.testing.assert_array_equal(mask.ravel(), base | anc)


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


# --- the cascade search and its candidate list --------------------------------

CAND_PARAMS = dict(ransac_iter=16, min_inliers=3)
CAND_SCREEN = 2         # the full pass scores impostors this screen drops


@functools.cache
def _cand_case():
    """6 users x 3 (K=16): the first two impressions of each enrolled (12
    rows), the third its probe; the reference's sets of the same rows."""
    d, _ = _gallery(np.random.default_rng(11), 6, 3, k=16)
    enrolled = np.sort(np.r_[0:18:3, 1:18:3])
    probes = np.arange(2, 18, 3)
    t = {f: torch.from_numpy(v) for f, v in d.items()}
    tset = minutiae_from_numpy(d)
    return (tg.take_templates(tset, enrolled), tg.take_templates(tset, probes),
            rm.as_set(t, rows=enrolled), rm.as_set(t, rows=probes))


def _ref_scores(gal, probes, cascade):
    return rc.probe_scores(probes, gal, rm.MatchParams(**CAND_PARAMS),
                           CAND_SCREEN if cascade else None)


@pytest.mark.parametrize("length", [2, 9])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("cascade", [False, True])
def test_identify_batch_candidates_equal_the_reference(cascade, padded, length):
    """Dense scores and lists of the cascade (on and off) against the
    reference over the unpadded gallery; padding rows (12 rows padded to
    16) score 0 and are never listed; a list longer than a probe's
    positive scores (2 mates, length 9) ends in -1 with score 0."""
    gal, probes, ref_gal, ref_probes = _cand_case()
    if padded:
        gal = tg.pad_gallery(gal, 8)
    kw = dict(chunk=8 if padded else 4, cascade=cascade,
              screen_iters=CAND_SCREEN)
    p = tr.MatchParams(**CAND_PARAMS)
    dense = tg.identify_batch(probes, gal, _cpu(), p, **kw)
    ids, scores = tg.candidate_list(dense, length)
    ref = _ref_scores(ref_gal, ref_probes, cascade)
    want_ids, want = rc.top_list(ref, length)
    assert ids.dtype == torch.int64 and scores.dtype == torch.float32
    assert ids.shape == scores.shape == (6, length)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(scores.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(dense.numpy()[:, :12], ref, atol=1e-6, rtol=0)
    assert dense.shape == (6, 16 if padded else 12)
    assert not dense[:, 12:].any()
    assert torch.equal(ids == -1, scores == 0)
    assert ((ids >= 0) & (ids < 12) | (ids == -1)).all()
    positive = (ref > 0).sum(axis=1)
    np.testing.assert_array_equal((ids >= 0).sum(dim=1).numpy(),
                                  np.minimum(positive, length))
    # the screen drops impostor pairs the full pass scores
    off = _ref_scores(ref_gal, ref_probes, False)
    assert ((off > 0) & (ref == 0)).any() == cascade


@pytest.mark.parametrize("copy_to", [1, 9])
def test_candidates_list_the_lower_row_first_between_equal_scores(copy_to):
    """Row 3 copied to row ``copy_to``: the two score alike against every
    probe, and the lower row comes first, as in the reference."""
    gal, probes, ref_gal, ref_probes = _cand_case()
    rows = np.arange(12)
    rows[copy_to] = 3
    gal = tg.take_templates(gal, rows)
    ref_gal = rm.MinutiaeSet(*(x[torch.as_tensor(rows)] for x in ref_gal))
    p = tr.MatchParams(**CAND_PARAMS)
    for cascade in (False, True):
        ids, scores = tg.candidate_list(tg.identify_batch(
            probes, gal, _cpu(), p, chunk=4, cascade=cascade,
            screen_iters=CAND_SCREEN), 4)
        want_ids, want = rc.top_list(_ref_scores(ref_gal, ref_probes, cascade), 4)
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_allclose(scores.numpy(), want, atol=1e-6, rtol=0)
        row = ids[1].tolist()       # probe 1 is user 1's, rows 2 and 3 its mates
        lo, hi = sorted((3, copy_to))
        assert lo in row and hi in row and row.index(lo) < row.index(hi)
        assert scores[1, row.index(lo)] == scores[1, row.index(hi)] > 0


def test_candidate_list_rule_on_chosen_scores():
    """Ties, zeros and the order, on scores chosen by hand."""
    s = torch.tensor([[0.0, 0.5, 0.25, 0.5, 0.0, 0.75],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    ids, top = tg.candidate_list(s, 5)
    assert ids.tolist() == [[5, 1, 3, 2, -1], [-1] * 5]
    assert top.tolist() == [[0.75, 0.5, 0.5, 0.25, 0.0], [0.0] * 5]
    want_ids, want = rc.top_list(s.numpy(), 5)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(top.numpy(), want)
    with pytest.raises(ValueError, match="candidates"):
        tg.candidate_list(s, 7)


@pytest.mark.parametrize("route", ["defaults", "explicit", "screen_as_full",
                                   "identify", "sharded_gallery"])
def test_identify_batch_defaults_are_the_full_pass_bit_for_bit(route):
    """Without the cascade, every probe x row pair through
    ``match_pairs_batch``: the defaults, the options named, the cascade at
    as many screen hypotheses as the full pass, ``identify`` a probe at a
    time and ``ShardedGallery`` on a group of one."""
    gal, probes, _, _ = _cand_case()
    gal = tg.pad_gallery(gal, 8)
    p = tr.MatchParams(**CAND_PARAMS)
    want = torch.stack([tcm.match_pairs_batch(
        tg.take_templates(probes, [i] * 16), gal, p).final_score
        for i in range(6)])
    if route == "defaults":
        got = tg.identify_batch(probes, gal, _cpu(), p, chunk=8)
    elif route == "explicit":
        got = tg.identify_batch(probes, gal, _cpu(), p, chunk=8, cascade=False,
                                screen_iters=CAND_SCREEN)
    elif route == "screen_as_full":
        got = tg.identify_batch(probes, gal, _cpu(), p, chunk=8, cascade=True,
                                screen_iters=16)
    elif route == "identify":
        got = torch.stack([tg.identify(TSet(*(x[i] for x in probes)), gal,
                                       _cpu(), p, chunk=8) for i in range(6)])
    else:
        with launch.start_ranks(1, device="cpu") as grp:
            svc = tg.ShardedGallery(grp, p, chunk=8)
            svc.load(gal)
            got = svc.identify_batch(probes)
    assert got.dtype == want.dtype and got.shape == (6, 16)
    assert torch.equal(got, want)


def test_cascade_search_reads_the_promoted_pairs_once(monkeypatch):
    """Every screen call is made before the promoted pairs' indices are
    read, whole column chunks up to ``_SCREEN_PAIRS`` a call; the full pass
    scores the promoted pairs alone; the counters count them."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import profiling
    gal, probes, _, _ = _cand_case()
    events = []
    screen, full = tg.screen_promote_batch, tg.match_pairs_batch

    def spy_screen(a, b, p, anchors):
        events.append(("screen", a.valid.shape[0]))
        return screen(a, b, p, anchors)

    def spy_full(a, b, p):
        events.append(("full", a.valid.shape[0]))
        return full(a, b, p)

    monkeypatch.setattr(tg, "screen_promote_batch", spy_screen)
    monkeypatch.setattr(tg, "match_pairs_batch", spy_full)
    monkeypatch.setattr(tg, "_SCREEN_PAIRS", 6 * 4 * 2)    # two chunks a call
    before = profiling.counters("gallery.")
    dense = tg.identify_batch(probes, gal, _cpu(), tr.MatchParams(**CAND_PARAMS),
                              chunk=4, cascade=True, screen_iters=CAND_SCREEN)
    moved = {k: v - before.get(k, 0)
             for k, v in profiling.counters("gallery.").items()}
    promoted = int((dense > 0).sum())
    assert events == [("screen", 48), ("screen", 24), ("full", promoted)]
    assert moved["gallery.screen_pairs"] == 72
    assert moved["gallery.promoted_pairs"] == promoted == 12


def _plain_twins(monkeypatch):
    """Every kernel's wrapper replaced by its plain twin, the CPU route, on
    the card's tensors. The anchors' twin runs 512 pairs at a time (each pair's bit is its
    own; its float64 (pairs, 8, K, K) temporaries), the others at the
    call's size, where the sampling's cumulative sums add in kernel I's
    order."""
    def sample(a, b, p):
        wa, wb, *rest = tr._pair_stats(a, b)
        return (wa, wb, *rest, *tr.sample_hypotheses(a, b, wa, wb, p))

    def anchors(a, b, wa, wb, reject, p):
        cut = lambda xs, s: [x[s:s + 512] for x in xs]
        return torch.cat([tr._anchor_promote(
            tr.MinutiaeSet(*cut(a, s)), tr.MinutiaeSet(*cut(b, s)),
            *cut((wa, wb, reject), s), p) for s in range(0, len(reject), 512)])

    monkeypatch.setattr(tcm, "sample_pairs_cuda", sample)
    monkeypatch.setattr(tcm, "hypothesis_scores_cuda", tcm.hypothesis_scores_plain)
    monkeypatch.setattr(tcm, "finish_match_cuda", tr._finish_match)
    monkeypatch.setattr(tcm, "anchor_pairs_cuda", anchors)


@pytest.mark.card
def test_cascade_search_on_the_card_equals_the_plain_route(card, monkeypatch):
    """``identify_batch`` with the cascade and a candidate list on the card
    (kernels I, D at H=32 and J; then I, D and H at H=300 on the promoted
    pairs) against the same search through the plain twins on the card:
    promote bits, scores and lists exact. 16 probes against 256 rows
    (K=64) in one 4,096-pair screen call, as the all-pairs screen is held
    in ``tests/test_torch_matching.py``."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        users_gallery)
    tm = minutiae_from_numpy(users_gallery(128, 3, k=64, seed=25), card)
    gal = tg.take_templates(tm, np.sort(np.r_[0:384:3, 1:384:3]))
    probes = tg.take_templates(tm, np.arange(2, 48, 3))
    mesh = tmesh.create_mesh()
    p = tr.MatchParams()
    bits = {"card": [], "plain": []}
    screen = tg.screen_promote_batch

    def run(route):
        def spy(a, b, sp, anc):
            out = screen(a, b, sp, anc)
            bits[route].append(out.cpu())
            return out
        monkeypatch.setattr(tg, "screen_promote_batch", spy)
        dense = tg.identify_batch(probes, gal, mesh, p, chunk=128, cascade=True,
                                  screen_iters=32)
        ids, top = tg.candidate_list(dense, 20)
        return dense.cpu(), ids.cpu(), top.cpu()

    got = run("card")
    _plain_twins(monkeypatch)
    want = run("plain")
    assert [b.shape[0] for b in bits["card"]] == [4096]
    for g, w in zip(bits["card"], bits["plain"]):
        assert torch.equal(g, w)
    promoted = bits["card"][0]
    assert 0 < int(promoted.sum()) < promoted.numel()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dense, ids = got[0], got[1]
    assert torch.equal(dense.view(16, 256) > 0,
                       (dense > 0) & promoted.view(16, 256))
    mates = torch.arange(16)[:, None] * 2 + torch.tensor([0, 1])
    assert (ids[:, :2].sort(dim=1).values == mates).float().mean() >= 0.9
