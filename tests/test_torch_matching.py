"""Parity of the port's 1:1 RANSAC matcher with the JAX package on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The JAX
package's Pallas matcher runs in interpret mode; the port's kernel wrappers
run their plain twins (CPU tensors). Tolerances, with their reasons:

- threefry uniforms, promote bits, counts, pair lists: exact (integer or
  bit-level results).
- hypothesis scores vs the Pallas kernels: 1e-6. Same formula; the float
  sums over K run in another order, and cos/sin/exp differ from XLA's in
  the last bit.
- full-pass final scores vs the Pallas route: 1e-5, and 1e-4 vs the XLA
  route (the repo's own XLA-vs-Pallas bound, tests/test_pallas_cc.py).
- sampled angles theta: exact (they depend only on the two selected
  minutiae's orientations). Sampled translations t: 1e-4 px. t is a
  difference of coordinates up to ~300 px rotated by cos/sin; the port
  rounds cos and sin from float64 (one result on the CPU and the card),
  while XLA's float32 cos and sin differ from that in the last bit for
  ~1.3% of angles, which moves t by up to 2 ulps (6.1e-5 px measured). A
  different selected minutia moves it by pixels.

Marked ``card``: kernels D, H, I and J against their plain twins on the card.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu.evaluation import (
    metrics as jmet)
from multimodal_biometric_fingerprints_palms_tpu.features.minutiae import (
    MinutiaeSet as JSet)
from multimodal_biometric_fingerprints_palms_tpu.matching import (
    dataset as jds, pallas_match as jpm, ransac as jr)
from multimodal_biometric_fingerprints_palms_tpu.utils import io as jio
from multimodal_biometric_fingerprints_palms_tpu_torch.evaluation import (
    metrics as tmet)
from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
    MinutiaeSet as TSet, minutiae_from_numpy)
from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
    cuda_match as tcm, dataset as tds, ransac as tr, runner as trun)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import io as tio
from torch_card import (  # noqa: F401  (card: a fixture)
    D_ATOL, FAR_GATES, FRR_GATES, H_FULL, SCREEN_ITERS, card, hypothesis_args,
    matcher_gallery)

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures" / "parity"


def _params(**kw):
    """The same MatchParams for both packages."""
    return jr.MatchParams(**kw), tr.MatchParams(**kw)


def _both(d: dict):
    """A numpy template batch as a JAX and a port MinutiaeSet."""
    return (JSet(**{f: jnp.asarray(v) for f, v in d.items()}),
            minutiae_from_numpy(d))


def _rigid_pairs(seed, pnum=4, k=64, n=40, impostors=0):
    """(P, K) A templates and rigid copies B (10 deg, (5, -3) px, 0.8 px
    noise); the last ``impostors`` pairs get an unrelated B."""
    g = np.random.default_rng(seed)
    xy = g.uniform(40, 200, (pnum, k, 2)).astype(np.float32)
    ori = g.uniform(-np.pi, np.pi, (pnum, k)).astype(np.float32)
    ty = g.integers(0, 2, (pnum, k)).astype(np.int32)
    q = g.uniform(0.4, 1, (pnum, k)).astype(np.float32)
    valid = np.zeros((pnum, k), bool)
    valid[:, :n] = True
    th = np.radians(10.0)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    xyb = (xy @ rot.T + np.array([5.0, -3.0], np.float32)
           + g.normal(0, 0.8, xy.shape).astype(np.float32))
    orib = (ori + th).astype(np.float32)
    if impostors:
        xyb[-impostors:] = g.uniform(40, 200, (impostors, k, 2))
        orib[-impostors:] = g.uniform(-np.pi, np.pi, (impostors, k))
    a = dict(xy=xy, minutia_type=ty, orientation=ori, quality=q, coherence=q,
             angular_stability=q, valid=valid)
    b = dict(a, xy=xyb.astype(np.float32), orientation=orib)
    return _both(a), _both(b)


def _np(x):
    return np.asarray(x)


def _jax_sample(ja, jb, p):
    wa = jr.compute_descriptor_weights(ja)
    wb = jr.compute_descriptor_weights(jb)
    u = jr.hypothesis_uniforms(p)
    th, t, cand = jax.vmap(
        lambda x, y, wx, wy: jr.sample_hypotheses(x, y, wx, wy, p, u))(
            ja, jb, wa, wb)
    return _np(th), _np(t), _np(cand)


# --- uniforms -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 32, 300])
@pytest.mark.parametrize("seed", [0, 42, 7])
def test_threefry_equals_jax_random_uniform(seed, n):
    ref = _np(jax.random.uniform(jax.random.PRNGKey(seed), (n, 2),
                                 jnp.float32))
    got = threefry.uniform(seed, (n, 2))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_hypothesis_uniforms_prefix_rule():
    jp, tp = _params(ransac_iter=32, full_iters=300)
    got = tr.hypothesis_uniforms(tp).numpy()
    np.testing.assert_array_equal(got, _np(jr.hypothesis_uniforms(jp)))
    full = tr.hypothesis_uniforms(tr.MatchParams(ransac_iter=300)).numpy()
    np.testing.assert_array_equal(got, full[:32])


# --- sampling and hypothesis scoring ----------------------------------------

def test_sample_hypotheses_matches_jax():
    (ja, ta), (jb, tb) = _rigid_pairs(1, pnum=4)
    jp, tp = _params(ransac_iter=300)
    th, t, cand = _jax_sample(ja, jb, jp)
    wa = tr.compute_descriptor_weights(ta)
    wb = tr.compute_descriptor_weights(tb)
    np.testing.assert_array_equal(wa.numpy(),
                                  _np(jr.compute_descriptor_weights(ja)))
    tth, tt, tcand = tr.sample_hypotheses(ta, tb, wa, wb, tp)
    np.testing.assert_array_equal(tcand.numpy(), cand)
    np.testing.assert_array_equal(tth.numpy(), th)
    np.testing.assert_allclose(tt.numpy(), t, rtol=0, atol=1e-4)


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("ransac_iter", [32, 70])
def test_plain_twin_matches_pallas_kernels(ransac_iter, grouped):
    """Given the JAX package's hypotheses, the plain twin of kernel D gives
    the Pallas kernels' counts exactly and their scores within 1e-6 (70
    hypotheses exercise the grouped kernel's H padding)."""
    (ja, ta), (jb, tb) = _rigid_pairs(2, pnum=3)
    jp, tp = _params(ransac_iter=ransac_iter)
    fn = (jpm.hypothesis_scores_pallas_grouped if grouped
          else jpm.hypothesis_scores_pallas)
    s_ref, c_ref, th, t = fn(ja, jb, jp, interpret=True)
    _, _, cand = _jax_sample(ja, jb, jp)
    wa, wb, _, _, possible, _ = tr._pair_stats(ta, tb)
    s, c = tcm.hypothesis_scores(ta, tb, wa, wb, torch.from_numpy(_np(th)),
                                 torch.from_numpy(_np(t)),
                                 torch.from_numpy(cand), possible, tp)
    assert (_np(s_ref) > 0).sum() > 0      # the comparison is not trivial
    assert c.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), _np(c_ref).astype(np.int32))
    np.testing.assert_allclose(s.numpy(), _np(s_ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("gates", [FRR_GATES, FAR_GATES])
def test_full_pass_matches_pallas_and_xla_routes(gates):
    """The port's one full pass is held to both of the JAX package's routes:
    the Pallas route (same scoring formula) and the XLA route."""
    (ja, ta), (jb, tb) = _rigid_pairs(3, pnum=6, impostors=2)
    jp, tp = _params(ransac_iter=96, **gates)
    ref = jpm.match_pairs_batch_pallas(ja, jb, jp, interpret=True)
    got = tcm.match_pairs_batch(ta, tb, tp)
    assert tcm.match_pairs_batch_kernel is tcm.match_pairs_batch
    assert (_np(ref.final_score) > 0).sum() >= 3
    np.testing.assert_array_equal(got.n_inliers.numpy(), _np(ref.n_inliers))
    np.testing.assert_allclose(got.final_score.numpy(),
                               _np(ref.final_score), rtol=0, atol=1e-5)

    xla = jr.match_pairs_batch(ja, jb, jp)
    np.testing.assert_array_equal(got.n_inliers.numpy(), _np(xla.n_inliers))
    np.testing.assert_allclose(got.final_score.numpy(),
                               _np(xla.final_score), rtol=0, atol=1e-4)
    one = tcm.match_minutiae_pair(TSet(*(x[0] for x in ta)),
                                  TSet(*(x[0] for x in tb)), tp)
    assert float(one.final_score) == float(got.final_score[0])
    assert int(one.n_inliers) == int(got.n_inliers[0])


# --- cascade screen ---------------------------------------------------------

def _weak_templates():
    """The weak-template anchor fixture of tests/test_cascade.py, plus a
    copy of A whose weights tie (quality 0.7 everywhere)."""
    k, n = 64, 13
    g = np.random.default_rng(11)

    def tmpl(xy, ori, q, nvalid=n):
        def pad(v):
            return np.concatenate([v, np.zeros((k - n,) + v.shape[1:],
                                               v.dtype)])
        return dict(xy=pad(xy.astype(np.float32)),
                    orientation=pad(ori.astype(np.float32)),
                    minutia_type=pad((q > 0.7).astype(np.int32)),
                    quality=pad(q.astype(np.float32)),
                    coherence=pad(q.astype(np.float32)),
                    angular_stability=pad(q.astype(np.float32)),
                    valid=np.arange(k) < nvalid)

    xy = g.uniform(40, 200, (n, 2))
    ori = g.uniform(-np.pi, np.pi, n)
    q = g.uniform(0.4, 1.0, n)
    a = tmpl(xy, ori, q)
    genuine = tmpl(xy + g.normal(0, 0.5, (n, 2)), ori, q + 0.01)
    impostor = tmpl(g.uniform(40, 200, (n, 2)), g.uniform(-np.pi, np.pi, n),
                    g.uniform(0.4, 1.0, n))
    tiny = tmpl(xy, ori, q, nvalid=5)
    tied = tmpl(xy + g.normal(0, 0.5, (n, 2)), ori, np.full(n, 0.7))
    a_tied = tmpl(xy, ori, np.full(n, 0.7))
    stack = lambda *ds: {f: np.stack([d[f] for d in ds]) for f in a}
    return (stack(a, a, tiny, a_tied, a_tied),
            stack(genuine, impostor, tiny, tied, impostor))


def test_anchor_promote_matches_jax():
    a, b = _weak_templates()
    (ja, ta), (jb, tb) = _both(a), _both(b)
    jp, tp = _params(ransac_iter=32, min_inliers=4, full_iters=64)
    ref = _np(jax.vmap(lambda x, y: jr.anchor_promote(x, y, jp))(ja, jb))
    got = tr.anchor_promote(ta, tb, tp).numpy()
    np.testing.assert_array_equal(got, ref)
    # genuine and tied-genuine promoted; impostors and tiny templates not
    np.testing.assert_array_equal(got, [True, False, False, True, False])


def _jax_screen(ja, jb, p):
    base = jpm.screen_pairs_batch_pallas(ja, jb, p, interpret=True)
    return _np(base | jax.vmap(lambda x, y: jr.anchor_promote(x, y, p))(
        ja, jb))


def test_screen_promote_batch_matches_jax():
    (ja, ta), (jb, tb) = _rigid_pairs(3, pnum=8, impostors=4)
    jp, tp = _params(ransac_iter=32, full_iters=300, min_inliers=6)
    ref = _jax_screen(ja, jb, jp)
    np.testing.assert_array_equal(tcm.screen_promote_batch(ta, tb, tp).numpy(),
                                  ref)
    np.testing.assert_array_equal(ref, [True] * 4 + [False] * 4)
    base = tcm.screen_promote_batch(ta, tb, tp, anchors=False).numpy()
    np.testing.assert_array_equal(
        base, _np(jpm.screen_pairs_batch_pallas(ja, jb, jp, interpret=True)))


def _split(ms: TSet, cuts) -> list:
    return [TSet(*(x[s:e] for x in ms)) for s, e in zip(cuts[:-1], cuts[1:])]


def test_match_pairs_batch_result_is_per_pair():
    """A pair's full-pass result does not depend on the batch it is matched
    in (PyTorch's float32 atan2 and power on the CPU differ by an ulp
    between the vectorized loop and its scalar tail; the finish takes them
    in float64)."""
    (_, ta), (_, tb) = _rigid_pairs(5, pnum=37, impostors=12)
    _, tp = _params(ransac_iter=24, min_inliers=6)
    whole = tcm.match_pairs_batch(ta, tb, tp)
    assert int((whole.final_score > 0).sum()) >= 15
    for cuts in ([0, 1, 2, 5, 21, 37], [0, 16, 32, 37]):
        parts = [tcm.match_pairs_batch(a, b, tp)
                 for a, b in zip(_split(ta, cuts), _split(tb, cuts))]
        for key in tr.MatchResult._fields:
            got = torch.cat([getattr(r, key) for r in parts])
            assert torch.equal(got, getattr(whole, key)), (cuts, key)


def test_plain_twin_is_per_pair_beyond_its_pair_chunk():
    """Kernel D's twin takes more than ``_PAIR_CHUNK`` pairs a slice at a
    time; every pair's scores and counts are those of a call on it alone."""
    (_, ta), (_, tb) = _rigid_pairs(9, pnum=tcm._PAIR_CHUNK + 9, k=8, n=8,
                                    impostors=100)
    _, tp = _params(ransac_iter=5, min_inliers=2)
    wa, wb, _, _, possible, _ = tr._pair_stats(ta, tb)
    theta, t, cand = tr.sample_hypotheses(ta, tb, wa, wb, tp)
    args = (ta, tb, wa, wb, theta, t, cand, possible)
    s, c = tcm.hypothesis_scores_plain(*args, tp)
    assert s.shape == c.shape == (tcm._PAIR_CHUNK + 9, 5)
    assert int((s > 0).sum()) > 0
    cut = [0, 3, tcm._PAIR_CHUNK + 1, tcm._PAIR_CHUNK + 9]
    parts = [tcm.hypothesis_scores_plain(
        *(ms for ms in (_split(ta, cut)[i], _split(tb, cut)[i])),
        *(x[cut[i]:cut[i + 1]] for x in args[2:]), tp) for i in range(3)]
    assert torch.equal(torch.cat([p[0] for p in parts]), s)
    assert torch.equal(torch.cat([p[1] for p in parts]), c)


# --- pair-index matching, dataset, protocol ------------------------------------

def _jax_route(stacked, pairs, p, cascade, screen_iters=32):
    """The JAX package's accelerator route composed by hand on the CPU:
    the Pallas screen | anchors, then the Pallas full pass on the promoted
    pairs (interpret mode)."""
    n = len(pairs)
    take = lambda idx: jax.tree.map(lambda x: x[idx], stacked)
    promoted = np.ones(n, bool)
    if cascade and p.ransac_iter > screen_iters:
        sp = p._replace(ransac_iter=screen_iters, full_iters=p.ransac_iter,
                        min_inliers=max(3, p.min_inliers - 2))
        promoted = _jit_screen(take(pairs[:, 0]), take(pairs[:, 1]), sp)
    score = np.zeros(n)
    n_inl = np.zeros(n, np.int32)
    idx = np.nonzero(promoted)[0]
    if idx.size:
        r = _jit_full(take(pairs[idx, 0]), take(pairs[idx, 1]), p)
        score[idx] = _np(r.final_score)
        n_inl[idx] = _np(r.n_inliers)
    return promoted, score, n_inl


@functools.partial(jax.jit, static_argnums=(2,))
def _jit_screen_j(a, b, p):
    base = jpm.screen_pairs_batch_pallas(a, b, p, interpret=True)
    return base | jax.vmap(lambda x, y: jr.anchor_promote(x, y, p))(a, b)


def _jit_screen(a, b, p):
    return _np(_jit_screen_j(a, b, p))


_jit_full = jax.jit(functools.partial(jpm.match_pairs_batch_pallas,
                                      interpret=True), static_argnums=(2,))


def _cascade_dataset():
    """tests/test_cascade.py's dataset: 4 users x 2 samples of 20 minutiae."""
    rng = np.random.default_rng(42)
    k, n_min, fields = 64, 20, {f: [] for f in JSet._fields}
    users = []
    for u in range(4):
        g = np.random.default_rng(100 + u)
        base_xy = g.random((n_min, 2)).astype(np.float32) * 120 + 60
        base_ori = (g.random(n_min).astype(np.float32) - 0.5) * np.pi
        types = (g.random(n_min) > 0.5).astype(np.int32)
        q = 0.5 + 0.5 * g.random(n_min).astype(np.float32)
        for _ in range(2):
            xy = np.zeros((k, 2), np.float32)
            xy[:n_min] = base_xy + rng.normal(0, 1.0, (n_min, 2))
            pad = lambda v: np.concatenate(
                [v, np.zeros((k - n_min,), v.dtype)])
            for f, v in (("xy", xy), ("orientation", pad(base_ori)),
                         ("minutia_type", pad(types)), ("quality", pad(q)),
                         ("coherence", pad(q)), ("angular_stability", pad(q)),
                         ("valid", np.arange(k) < n_min)):
                fields[f].append(v)
            users.append(u)
    stacked = {f: np.stack(v) for f, v in fields.items()}
    js, ts = _both(stacked)
    ds = tds.MinutiaeDataset(users=[str(u) for u in range(4)],
                             user_index=np.asarray(users, np.int32),
                             sample_index=np.tile([0, 1], 4).astype(np.int32),
                             matrices=[], stacked=ts)
    return js, ds


@pytest.mark.parametrize("cascade", [False, True])
def test_match_pair_indices_matches_jax_route(cascade):
    js, ds = _cascade_dataset()
    pairs = np.asarray([[0, 1], [2, 3], [0, 2], [4, 6], [1, 5], [6, 7]],
                       np.int32)
    jp, tp = _params(ransac_iter=128, min_inliers=6)
    promoted, score, n_inl = _jax_route(js, pairs, jp, cascade, 16)
    got = trun.match_pair_indices(ds, pairs, tp, chunk=4, cascade=cascade,
                                  screen_iters=16)
    np.testing.assert_array_equal(got["final_score"] > 0, score > 0)
    np.testing.assert_array_equal(got["n_inliers"], n_inl)
    np.testing.assert_allclose(got["final_score"], score, rtol=0, atol=1e-5)
    assert (score[[0, 1, 5]] > 0.3).all()         # the genuine pairs match
    if cascade:                                    # the screen drops impostors
        assert not promoted[[2, 3, 4]].any()


@pytest.fixture(scope="module")
def parity_datasets():
    return (jds.load_dataset(FIXTURES, max_per_user=4),
            tds.load_dataset(FIXTURES, max_per_user=4, device="cpu"))


def test_load_dataset_and_pairs_match_jax(parity_datasets):
    jd, td = parity_datasets
    assert td.users == jd.users and len(td.users) == 8
    np.testing.assert_array_equal(td.user_index, jd.user_index)
    np.testing.assert_array_equal(td.sample_index, jd.sample_index)
    for x, y in zip(td.matrices, jd.matrices):
        np.testing.assert_array_equal(x, y)
    for f in JSet._fields:
        got, ref = getattr(td.stacked, f).numpy(), _np(getattr(jd.stacked, f))
        assert got.dtype == ref.dtype, f
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tds.genuine_pairs(td), jds.genuine_pairs(jd))
    np.testing.assert_array_equal(tds.genuine_pairs(td, 3),
                                  jds.genuine_pairs(jd, 3))
    for peers, seed in ((100, 42), (3, 7)):
        np.testing.assert_array_equal(tds.impostor_pairs(td, peers, seed),
                                      jds.impostor_pairs(jd, peers, seed))
    small = tds.load_dataset(FIXTURES, max_per_user=1, k=32, device="cpu")
    assert small.stacked.xy.shape == (8, 32, 2)


def test_minutiae_json_round_trip_matches_jax_io(tmp_path):
    g = np.random.default_rng(5)
    k = 16
    args = (g.uniform(0, 300, (k, 2)).astype(np.float32),
            g.integers(0, 2, k), g.normal(size=k), g.random(k), g.random(k),
            g.random(k), np.arange(k) < 11)
    recs = tio.minutiae_to_json(*args)
    assert recs == jio.minutiae_to_json(*args) and len(recs) == 11
    tio.save_minutiae_json(tmp_path / "t" / "u1_1_minutiae.json", recs)
    jio.save_minutiae_json(tmp_path / "j.json", recs)
    assert ((tmp_path / "t" / "u1_1_minutiae.json").read_text()
            == (tmp_path / "j.json").read_text())
    mat = tio.load_minutiae_matrix(tmp_path / "j.json")
    np.testing.assert_array_equal(mat, jio.load_minutiae_matrix(
        tmp_path / "j.json"))
    for kk in (8, 64):
        for x, y in zip(tio.pad_minutiae(mat, kk), jio.pad_minutiae(mat, kk)):
            np.testing.assert_array_equal(x, y)
    (tmp_path / "e.json").write_text(json.dumps([]))
    assert tio.load_minutiae_matrix(tmp_path / "e.json").shape == (0, 7)
    assert tio.MINUTIA_TYPES == jio.MINUTIA_TYPES


def test_whole_slice_protocol_matches_jax_route(parity_datasets):
    """The FRR/FAR protocol of the JAX runner (config values: cascade on,
    32 screen hypotheses, stop ratio 0.15, FRR gates 30 px/30 deg/6, FAR
    gates 15 px/10 deg/12, 50 points, 100 impostor peers, seed 42) on the
    32 parity templates, all 4 impressions per user, at RANSAC 48 instead
    of 300 (a cut for CPU time)."""
    jd, td = parity_datasets
    g_pairs = tds.genuine_pairs(td)
    i_pairs = tds.impostor_pairs(td, 100, 42)
    assert len(g_pairs) == 48 and len(i_pairs) == 448
    curves = {}
    for name, pairs, gates in (("frr", g_pairs, FRR_GATES),
                               ("far", i_pairs, FAR_GATES)):
        jp, tp = _params(ransac_iter=48, stop_inlier_ratio=0.15, **gates)
        _, ref, _ = _jax_route(jd.stacked, pairs, jp, cascade=True)
        got = trun.match_pair_indices(td, pairs, tp, chunk=128, cascade=True)
        np.testing.assert_allclose(got["final_score"], ref, rtol=0, atol=1e-4)
        curves[name] = (got["final_score"], ref)
    assert curves["frr"][0].mean() - curves["far"][0].mean() > 0.3
    eers = []
    for k, met in ((0, tmet), (1, jmet)):
        thr, frr = met.evaluate_frr_across_thresholds(curves["frr"][k], 50)
        _, far = met.evaluate_far_across_thresholds(curves["far"][k], 50)
        eers.append(met.compute_eer(thr, frr, far))
    assert eers[0] == eers[1]


@pytest.mark.parametrize("case", ["overlap", "separated", "empty"])
def test_evaluation_metrics_equal_jax_package(case):
    """The port's FRR/FAR sweeps and EER equal the JAX package's exactly."""
    g = np.random.default_rng(9)
    gen = {"overlap": g.beta(5, 2, 40), "separated": g.uniform(0.8, 1, 40),
           "empty": np.zeros(0)}[case]
    imp = g.beta(1, 6, 300) * (0.5 if case == "separated" else 1.0)
    for n in (50, 7):
        for name in ("evaluate_frr_across_thresholds",
                     "evaluate_far_across_thresholds"):
            for x in (gen, imp):
                for got, ref in zip(getattr(tmet, name)(x, n),
                                    getattr(jmet, name)(x, n)):
                    np.testing.assert_array_equal(got, ref)
        thr, frr = jmet.evaluate_frr_across_thresholds(gen, n)
        _, far = jmet.evaluate_far_across_thresholds(imp, n)
        assert tmet.compute_eer(thr, frr, far) == jmet.compute_eer(thr, frr,
                                                                  far)


# --- the identities kernel D's distance loop rests on -----------------------
#
# The twin quantizes q = min(round(d2 * 256), 2^18 - 1) and keeps the first
# j of the smallest q. csrc/match.cu has no rounding instruction, no `* 256`
# and no clamp instruction in its loop: it scales the positions by a power
# of two, saturates the fused multiply-add, and rounds by adding a bias
# whose ulp is the quantization step. Held here in float32 on the CPU.

_S = float(2 ** 18 - 1)
CSRC = Path(tcm.__file__).resolve().parent.parent / "csrc" / "match.cu"


def _rounding_inputs():
    """Every half-integer in [0, 2^18 + 2] with its float32 neighbours, the
    integers between, and values far beyond the saturation."""
    half = np.arange(0, 2 ** 18 + 3, dtype=np.float32) + np.float32(0.5)
    whole = np.arange(0, 2 ** 18 + 3, dtype=np.float32)
    far = np.asarray([1e6, 1e12, 3e14], np.float32)
    x = np.concatenate([half, np.nextafter(half, np.float32(0)),
                        np.nextafter(half, np.float32(np.inf)), whole, far])
    return torch.from_numpy(x)


def test_bias_add_rounds_half_to_even_after_the_clamp():
    """(min(x, S) + 1.5 * 2^23) - 1.5 * 2^23 == min(round(x), S): rint is
    monotone and fixes the integer S, and the add rounds to nearest even at
    an ulp of 1."""
    x = _rounding_inputs()
    want = torch.clamp(torch.round(x), max=_S)
    bias = torch.tensor(12582912.0)
    got = (torch.clamp(x, max=_S) + bias) - bias
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_d_saturate_and_bias_give_the_twins_quantization():
    """The form the kernel ships: x / 2^18 saturated at 1 (the fma's .sat),
    plus 48.0 (ulp 2^-18 in [32, 64)), leaves q in the low mantissa bits,
    bits = 0x42400000 + q with q <= 2^18; min(q, S) is the twin's value."""
    src = CSRC.read_text()
    assert "constexpr float kScale = 0.03125f;" in src          # 2^-5
    assert "constexpr float kBias = 48.0f;" in src
    assert "constexpr unsigned kKeyBase = 0x20000000u;" in src
    assert "fma.rn.sat.f32" in src
    loop = src[src.index("nn_key("):src.index("__global__")]
    for word in ("rintf", "nearbyintf", "roundf", "fminf", "256"):
        assert word not in loop, word
    x = _rounding_inputs()
    want = torch.clamp(torch.round(x), max=_S)
    v = torch.clamp(x * 2.0 ** -18, max=1.0) + 48.0
    assert v.dtype == torch.float32
    q = v.view(torch.int32) - 0x42400000
    assert int(q.min()) == 0 and int(q.max()) == 2 ** 18
    np.testing.assert_array_equal(torch.clamp(q, max=2 ** 18 - 1).numpy(),
                                  want.numpy().astype(np.int32))
    # the key the kernel minimises, (bits << 7) + j modulo 2^32, is
    # kKeyBase + (q << 7) + j: it never wraps, so it orders like (q, j)
    assert (0x42400000 << 7) % 2 ** 32 == 0x20000000
    assert 0x20000000 + (2 ** 18 << 7) + 127 < 2 ** 32


def _fixture_distances(parity_td, hyps=12):
    """Transformed A positions and B positions of the fixture pairs as the
    twin forms them, displaced slots included: tax, tay (P, H, K), bx, by
    (P, K), B's validity, and the twin's (j, q) per (P, H, K). Pair 3 has
    no valid B slot, pair 5 no valid A slot, pairs 6-11 scattered validity,
    and the last two hypotheses of every pair put A minutia 0 or 1 onto the
    point the invalid B slots are displaced to."""
    pairs = np.concatenate([tds.genuine_pairs(parity_td),
                            tds.impostor_pairs(parity_td, 100, 42)])[:48]
    a, b = trun._gather(parity_td, pairs[:, 0]), trun._gather(parity_td,
                                                              pairs[:, 1])
    g = np.random.default_rng(23)
    a = a._replace(valid=a.valid.clone())
    b = b._replace(valid=b.valid.clone())
    b.valid[3] = False
    a.valid[5] = False
    b.valid[6:12] &= torch.from_numpy(g.random((6, 64)) < 0.7)
    a.valid[6:12] &= torch.from_numpy(g.random((6, 64)) < 0.7)
    wa, wb, *_ = tr._pair_stats(a, b)
    p = tr.MatchParams(ransac_iter=hyps)
    theta, t, _ = tr.sample_hypotheses(a, b, wa, wb, p)
    for h, i in ((-1, 0), (-2, 1)):
        rot = tr._apply_rigid(a.xy[:, i], theta[:, h], 0.0)
        t[:, h] = torch.tensor([-1e6 + 3.0, -1e6 - 2.0]) - rot
    fa, fb = tcm._features(a, b, wa, wb)
    assert float(fa[:, 0].max()) == 1e6 and float(fb[:, 0].min()) == -1e6
    c, s = tr._cos_sin(theta[..., None])
    tax = tr._fma(c, fa[:, 0, None], -(s * fa[:, 1, None])) + t[..., 0, None]
    tay = tr._fma(s, fa[:, 0, None], c * fa[:, 1, None]) + t[..., 1, None]
    dx = tax[..., None] - fb[:, 0, None, None]
    dy = tay[..., None] - fb[:, 1, None, None]
    j, d2_at = tr._nn_select(tr._fma(dx, dx, dy * dy))
    return (tax, tay, fb[:, 0], fb[:, 1], b.valid, j,
            (d2_at * 256.0).to(torch.int64))


@pytest.mark.parametrize("scale", [16.0, 2.0 ** -5])
def test_prescaled_fma_equals_scaled_distance(parity_datasets, scale):
    """fma(s dx, s dx, (s dy)(s dy)) == s^2 fma(dx, dx, dy dy) bit for bit
    for a power of two s, through the port's ``_fma``, on the fixture pairs'
    real coordinates and their displaced slots: 16 gives d2 * 256, 2^-5
    (the kernel's) gives d2 * 256 / 2^18."""
    tax, tay, bx, by, *_ = _fixture_distances(parity_datasets[1])
    dx, dy = tax[..., None] - bx[:, None, None], tay[..., None] - by[:, None, None]
    d2 = tr._fma(dx, dx, dy * dy)
    assert float(d2.max()) > 1e12 and float(d2.min()) < 1.0
    want = d2 * (scale * scale)
    sdx = tax[..., None] * scale - (bx * scale)[:, None, None]
    sdy = tay[..., None] * scale - (by * scale)[:, None, None]
    got = tr._fma(sdx, sdx, sdy * sdy)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


def test_kernel_d_key_selects_the_twins_neighbour(parity_datasets):
    """The kernel's search, emulated: scaled positions, saturated fma, bias,
    integer key and unsigned minimum over the valid B slots only (kept in
    their order, so the compacted position orders like j); one more
    distance to the displaced point stands for every invalid slot under
    the lowest invalid index; the smaller (q, j) wins; `q >= S -> (S, 0)`.
    It picks the twin's j and q for every A slot: with scattered validity,
    where an A minutia lands on the displaced point (an invalid slot is
    then the nearest), and with no valid B slot (j = 0, q = 2^18 - 1)."""
    src = CSRC.read_text()
    assert "if (qi < q || (qi == q && j_invalid < j)) { q = qi; j = j_invalid; }" in src
    tax, tay, bx, by, b_valid, j_twin, q_twin = _fixture_distances(
        parity_datasets[1])
    sc, k = 2.0 ** -5, bx.shape[-1]
    px, py = tax * sc, tay * sc

    def q_bits(ox, oy):
        dx, dy = px[..., None] - ox, py[..., None] - oy
        v = torch.clamp(tr._fma(dx, dx, dy * dy), max=1.0) + 48.0
        return (v.view(torch.int32).to(torch.int64) << 7) & 0xFFFFFFFF

    key = q_bits((bx * sc)[:, None, None], (by * sc)[:, None, None]) \
        + torch.arange(k)
    key = torch.where(b_valid[:, None, None, :], key, 0xFFFFFFFF)
    best = key.min(dim=-1).values
    q, j = (best - 0x20000000) >> 7, best & 127
    first_invalid = torch.where(b_valid.all(dim=-1), k,
                                torch.argmin(b_valid.to(torch.uint8), dim=-1))
    far = torch.tensor(-1e6) * sc
    qi = (q_bits(far[None], far[None])[..., 0] - 0x20000000) >> 7
    ji = first_invalid[:, None, None].expand_as(j)
    take = (ji < k) & ((qi < q) | ((qi == q) & (ji < j)))
    q, j = torch.where(take, qi, q), torch.where(take, ji, j)
    sat = q >= 2 ** 18 - 1
    q, j = torch.where(sat, 2 ** 18 - 1, q), torch.where(sat, 0, j)
    assert 0.05 < float(sat.float().mean()) < 0.95
    # an invalid slot is the nearest neighbour somewhere, unsaturated
    assert int((take & ~sat).sum()) >= 40
    np.testing.assert_array_equal(j.numpy(), j_twin.numpy())
    np.testing.assert_array_equal(q.numpy(), q_twin.numpy())
    assert bool((j_twin[3, :-2] == 0).all())
    assert bool((q_twin[3, :-2] == 2 ** 18 - 1).all())


def test_all_invalid_b_template_counts_nothing(parity_datasets):
    """Twin level: with every B slot invalid each A minutia's nearest
    neighbour is slot 0 at the saturated distance, beyond the distance
    gate: count 0 and score 0 for every hypothesis."""
    td = parity_datasets[1]
    pairs = tds.genuine_pairs(td)[:4]
    a, b = trun._gather(td, pairs[:, 0]), trun._gather(td, pairs[:, 1])
    b = b._replace(valid=torch.zeros_like(b.valid))
    wa, wb, _, _, possible, _ = tr._pair_stats(a, b)
    p = tr.MatchParams(ransac_iter=8, **FRR_GATES)
    theta, t, cand = tr.sample_hypotheses(a, b, wa, wb, p)
    s, c = tcm.hypothesis_scores(a, b, wa, wb, theta, t, cand, possible, p)
    assert int(c.abs().sum()) == 0 and float(s.abs().sum()) == 0.0
    fa, fb = tcm._features(a, b, wa, wb)
    d2 = ((fa[:, 0, :, None] - fb[:, 0, None, :]) ** 2
          + (fa[:, 1, :, None] - fb[:, 1, None, :]) ** 2)
    j, d2_at = tr._nn_select(d2)
    assert int(j.abs().sum()) == 0
    assert bool((d2_at == (2 ** 18 - 1) / 256.0).all())


def test_kernel_d_angle_wrap_equals_remainder():
    """csrc/wrap_angle.cuh, the angle wrap of kernels D and H, wraps the
    orientation difference without fmodf where the quotient is 0 or 1: v
    below 2 pi, v -+ 2 pi below 4 pi (an exact float subtraction), fmodf
    beyond. In float32 that is the twin's |remainder(x + pi, 2 pi) - pi|
    bit for bit."""
    src = (CSRC.parent / "wrap_angle.cuh").read_text()
    assert "else if (av < 2.0f * kTwoPi) r = copysignf(__fsub_rn(av, kTwoPi), v);" in src
    g = np.random.default_rng(17)
    pi, two_pi = np.float32(math.pi), np.float32(2.0 * math.pi)
    edge = np.asarray([0.0, math.pi, -math.pi, 2 * math.pi, -2 * math.pi,
                       3 * math.pi, -3 * math.pi, 5 * math.pi, -5 * math.pi],
                      np.float32)
    edge = np.concatenate([edge, np.nextafter(edge, np.float32(np.inf)),
                           np.nextafter(edge, np.float32(-np.inf))])
    x = np.concatenate([
        g.uniform(-3 * math.pi - 1, 3 * math.pi + 1, 1_000_000),
        g.uniform(-100, 100, 200_000), edge]).astype(np.float32)
    v = x + pi
    av = np.abs(v)
    r = np.where(av < two_pi, v,
                 np.where(av < np.float32(2.0) * two_pi,
                          np.copysign(av - two_pi, v), np.fmod(v, two_pi)))
    r = np.where(r < 0, r + two_pi, r)
    got = np.abs(r - pi)
    assert got.dtype == np.float32
    t = torch.from_numpy(x)
    want = torch.abs(torch.remainder(t + math.pi, 2.0 * math.pi) - math.pi)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.numpy().view(np.uint32))


# --- kernel H, the finish ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _finish_tool():
    """``tools/finish_check.py``: the finish's card inputs and the
    comparison of kernel H with the plain finish, which the card tests
    share with the script that runs them on a card (this file imports JAX,
    which the card's machine lacks)."""
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "tools" / "finish_check.py"
    spec = importlib.util.spec_from_file_location("finish_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finish_args(device="cpu", pnum=16, k=32, **kw):
    tool = _finish_tool()
    args = tool.finish_inputs(*tool.templates(0, pnum, k),
                              tr.MatchParams(ransac_iter=24, **kw), "cpu")
    move = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x
    return tuple(type(x)(*map(move, x)) if isinstance(x, tr.MinutiaeSet)
                 else move(x) for x in args)


def test_finish_match_sends_cpu_tensors_to_the_plain_finish(monkeypatch):
    """The finish's dispatcher runs ``ransac._finish_match`` on CPU
    tensors, unchanged, and launches nothing."""
    calls = []

    def spy(*args):
        calls.append(args[8].device)
        return tr._finish_match(*args)

    monkeypatch.setattr(tcm, "_finish_match", spy)
    args = _finish_args()
    before = build.launches()
    got = tcm.finish_match(*args)
    want = tr._finish_match(*args)
    assert calls == [torch.device("cpu")]
    assert build.launches() == before
    assert int((want.final_score > 0).sum()) >= 4
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_match_pairs_batch_finishes_through_the_dispatcher(monkeypatch):
    """``match_pairs_batch`` finishes through ``finish_match``, once a
    call, inside the ``match.finish`` span that
    ``finish_idle_pct.identify`` reads."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        minutiae_from_numpy)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import profiling
    inside = []
    shipped = tcm.finish_match

    def spy(*args):
        inside.append(profiling._stack()[-1].name)
        return shipped(*args)

    monkeypatch.setattr(tcm, "finish_match", spy)
    a, b = (minutiae_from_numpy(x) for x in _finish_tool().templates(1, 8, 32))
    p = tr.MatchParams(ransac_iter=16)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = tcm.match_pairs_batch(a, b, p)
    names = [s.name for s in profiling.recorded()]
    profiling.clear()
    assert inside == ["match.finish"] and names.count("match.finish") == 1
    monkeypatch.setattr(tcm, "finish_match", shipped)
    want = tcm.match_pairs_batch(a, b, p)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["cpu", "meta", "k48", "k256", "shapes"])
def test_finish_match_cuda_refuses_what_kernel_h_does_not_take(case):
    """Kernel H's wrapper raises on a CPU or other non-CUDA tensor, on K
    not a power of two or over 128, and on shapes that do not fit one
    another, before it launches anything."""
    before = build.launches()
    if case in ("cpu", "meta"):
        args, match = _finish_args(case), "CUDA tensor"
    elif case == "shapes":
        args, match = list(_finish_args("meta")), "inconsistent"
        args[11] = args[11][:, :-1]                    # h_t one hypothesis short
    else:
        k = int(case[1:])
        args, match = _finish_args("meta", pnum=4, k=64), "power of two"
        grow = lambda x: torch.zeros(x.shape[:1] + (k,) + x.shape[2:],
                                     dtype=x.dtype, device="meta")
        args = (tr.MinutiaeSet(*map(grow, args[0])),
                tr.MinutiaeSet(*map(grow, args[1])), grow(args[2]),
                grow(args[3]), *args[4:])
    with pytest.raises(ValueError, match=match):
        tcm.finish_match_cuda(*args)
    if case == "meta":
        with pytest.raises(ValueError, match="CUDA tensor"):
            tcm.finish_match(*args)
    assert build.launches() == before


# --- kernel D on the card, against its twin ----------------------------------

D_CASES = {
    "FRR gates, H=300": dict(ransac_iter=H_FULL, **FRR_GATES),
    "FAR gates, H=300": dict(ransac_iter=H_FULL, **FAR_GATES),
    "screen, H=32 of 300": dict(ransac_iter=SCREEN_ITERS, full_iters=H_FULL,
                                **{**FRR_GATES, "min_inliers": 4}),
    "scattered validity, FRR gates": dict(ransac_iter=H_FULL, **FRR_GATES),
    "4,096 pairs, FRR gates": dict(ransac_iter=H_FULL, **FRR_GATES),
}


@pytest.fixture(scope="module")
def d_gallery(card):
    return matcher_gallery(card)


@pytest.mark.card
@pytest.mark.parametrize("case", list(D_CASES))
def test_kernel_d_equals_its_twin_on_the_card(d_gallery, case):
    """Kernel D on the (P, K) templates of a 512-pair chunk (the fixture
    templates and the main path's blob-print templates) under the FRR
    gates, the FAR gates and the cascade screen's parameters; with
    validity scattered over the slots and hypotheses onto the invalid B
    slots' point; and on 4,096 fixture pairs: counts equal, scores within
    D_ATOL and finite, some score above 0."""
    ds, pairs, many = d_gallery
    args = hypothesis_args(ds, many if case.startswith("4,096") else pairs,
                           tr.MatchParams(**D_CASES[case]),
                           scattered=case.startswith("scattered"))
    sk, ck = tcm.hypothesis_scores_cuda(*args)
    sp, cp = tcm.hypothesis_scores_plain(*args)
    assert torch.equal(ck, cp)
    assert bool(torch.isfinite(sk).all())
    assert float((sk - sp).abs().max()) <= D_ATOL
    assert int((sk > 0).sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("use_type", [True, False])
@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("k", [32, 64, 128])
def test_kernel_h_equals_the_plain_finish_on_the_card(card, k, cross_check,
                                                      use_type):
    """Kernel H against ``_finish_match`` on the same card inputs, 3 seeds
    x P in {1, 3, 1024, 2049}, with padded gallery rows, rejected pairs,
    rows with no positive hypothesis, tied top scores, a stop reached after
    the best score and doubled minutiae: counts and ratios equal, scores,
    angles and translations within 1e-6 (a float64 sum's order)."""
    tool = _finish_tool()
    for seed in tool.SEEDS:
        for pnum in tool.PAIRS:
            r = tool.case(seed, pnum, k, cross_check, use_type, card)
            assert tool.ok(r), (seed, pnum, r)


@pytest.mark.card
def test_kernel_h_spread_reject_on_the_card(card):
    """The same under wide gates, where the spread reject zeroes a ring of
    A minutiae about a cluster of B and many impostors."""
    tool = _finish_tool()
    for seed in tool.SEEDS:
        for pnum in tool.PAIRS:
            r = tool.case(seed, pnum, 64, True, True, card, wide=True)
            assert tool.ok(r), (seed, pnum, r)


@pytest.mark.card
def test_match_pairs_batch_launches_kernel_h_once(card):
    assert _finish_tool().launches_per_call(card) == 1


@pytest.mark.card
def test_identify_through_kernel_h_equals_the_plain_finish(card):
    r = _finish_tool().identify_against_plain(card)
    assert r["max"] <= 1e-6 and r["mates_top1"] == 3, r


# --- kernel I, the statistics and the sampling --------------------------------

@functools.lru_cache(maxsize=None)
def _sample_tool():
    """``tools/sample_check.py``: the sampling's card inputs and the
    comparison of kernel I with the plain route, shared with the script
    that runs them on a card."""
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "tools" / "sample_check.py"
    spec = importlib.util.spec_from_file_location("sample_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sample_pairs_input(device="cpu", pnum=24, k=32):
    a, b = _sample_tool().templates(0, pnum, k)
    return minutiae_from_numpy(a, device), minutiae_from_numpy(b, device)


def test_sample_pairs_sends_cpu_tensors_to_the_plain_route(monkeypatch):
    """The sampling's dispatcher runs ``_pair_stats`` then
    ``sample_hypotheses`` on CPU tensors, unchanged, inside the spans
    ``match.stats`` and ``match.sample``, and launches nothing."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import profiling
    calls = []
    for name in ("_pair_stats", "sample_hypotheses"):
        shipped = getattr(tcm, name)

        def spy(*args, _f=shipped, _n=name):
            calls.append((_n, profiling._stack()[-1].name, args[0].xy.device))
            return _f(*args)

        monkeypatch.setattr(tcm, name, spy)
    a, b = _sample_pairs_input()
    p = tr.MatchParams(ransac_iter=40)
    before = build.launches()
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = tcm.sample_pairs(a, b, p)
    profiling.clear()
    stats = tr._pair_stats(a, b)
    want = (*stats, *tr.sample_hypotheses(a, b, stats[0], stats[1], p))
    cpu = torch.device("cpu")
    assert calls == [("_pair_stats", "match.stats", cpu),
                     ("sample_hypotheses", "match.sample", cpu)]
    assert build.launches() == before
    assert int(want[5].sum()) >= 3 and int((want[8] == 0).sum()) >= 40
    assert len(got) == len(want) == 9
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_match_pairs_batch_samples_through_the_dispatcher(monkeypatch):
    """``match_pairs_batch`` and the screen sample through
    ``sample_pairs``, once a call."""
    shipped = tcm.sample_pairs
    seen = []

    def spy(*args):
        seen.append(args[2].ransac_iter)
        return shipped(*args)

    monkeypatch.setattr(tcm, "sample_pairs", spy)
    a, b = _sample_pairs_input(pnum=8)
    p = tr.MatchParams(ransac_iter=16)
    got = tcm.match_pairs_batch(a, b, p)
    tcm.screen_promote_batch(a, b, p._replace(ransac_iter=8, full_iters=16),
                             anchors=False)
    assert seen == [16, 8]
    monkeypatch.setattr(tcm, "sample_pairs", shipped)
    for x, y in zip(got, tcm.match_pairs_batch(a, b, p)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["cpu", "meta", "k48", "k256", "shapes",
                                  "h_past_the_grid"])
def test_sample_pairs_cuda_refuses_what_kernel_i_does_not_take(case):
    """Kernel I's wrapper raises on a CPU or other non-CUDA tensor, on K
    not a power of two or over 128, on fields whose shapes do not fit one
    another, and on H past what the kernel indexes, before it draws or
    uploads a uniform or launches anything."""
    before = build.launches()
    p = tr.MatchParams(ransac_iter=12)
    dev = "cpu" if case == "cpu" else "meta"
    a, b = _sample_pairs_input(dev, pnum=4, k=64 if case[0] == "k" else 32)
    match = "CUDA tensor"
    if case[0] == "k":
        k = int(case[1:])
        grow = lambda x: torch.zeros(x.shape[:1] + (k,) + x.shape[2:],
                                     dtype=x.dtype, device="meta")
        a, b = tr.MinutiaeSet(*map(grow, a)), tr.MinutiaeSet(*map(grow, b))
        match = "power of two"
    elif case == "shapes":
        b = b._replace(quality=b.quality[:, :-1])        # one slot short
        match = "inconsistent"
    elif case == "h_past_the_grid":
        p = p._replace(ransac_iter=2 ** 31)
        match = "out of range"
    cached = dict(tcm._UNIFORMS)
    with pytest.raises(ValueError, match=match):
        tcm.sample_pairs_cuda(a, b, p)
    if case == "meta":
        with pytest.raises(ValueError, match="CUDA tensor"):
            tcm.sample_pairs(a, b, p)
    assert build.launches() == before and tcm._UNIFORMS == cached


def test_device_uniforms_keeps_one_copy_a_key(monkeypatch):
    """The uniforms' cache holds one tensor a (seed, ransac_iter,
    full_iters, device), equal to ``hypothesis_uniforms``, and hands the
    same tensor back on every later call."""
    monkeypatch.setattr(tcm, "_UNIFORMS", {})
    cpu, meta = torch.device("cpu"), torch.device("meta")
    params = [tr.MatchParams(), tr.MatchParams(seed=7),
              tr.MatchParams(ransac_iter=32, full_iters=300),
              tr.MatchParams(ransac_iter=32)]
    first = {(p, d): tcm.device_uniforms(p, d) for p in params
             for d in (cpu, meta)}
    for (p, d), u in first.items():
        assert tcm.device_uniforms(p, d) is u
        assert u.device == d and u.dtype == torch.float32
        assert u.shape == (p.ransac_iter, 2)
        if d == cpu:
            assert torch.equal(u, tr.hypothesis_uniforms(p))
    assert sorted(tcm._UNIFORMS, key=str) == sorted(
        ((p.seed, p.ransac_iter, p.full_iters, d) for p in params
         for d in (cpu, meta)), key=str)
    screen = tcm.device_uniforms(params[2], cpu)    # the prefix rule's draw
    assert torch.equal(screen, tcm.device_uniforms(params[0], cpu)[:32])


@pytest.mark.parametrize("k,table", [
    (64, {1: 0, 2: 256, 3: 128, 8: 128, 9: 64, 32: 64, 33: 32, 1024: 32,
          32768: 32, 32769: 1024, 1215000: 1024}),
    (128, {1: 0, 4: 256, 5: 128, 16: 128, 17: 64, 64: 64, 65: 32,
           65536: 32, 65537: 1024}),
    (32, {1: 0, 2: 128, 16: 64, 17: 32, 16384: 32, 16385: 1024})])
def test_cumsum_chunk_follows_the_cards_scan(k, table):
    """The leaves a block of the card's ``torch.cumsum`` scans at once, as
    measured on the card (the chunk sizes whose Sklansky order matched every
    row there): at 64 leaves 32 from 33 to 32,768 rows, 1,024 beyond; 0,
    cub's scan, for one row."""
    assert {rows: tcm.cumsum_chunk(rows, k) for rows in table} == table


@pytest.mark.card
@pytest.mark.parametrize("use_type", [True, False])
@pytest.mark.parametrize("hyps", [(300, 0), (32, 300)])
@pytest.mark.parametrize("k", [32, 64, 128])
def test_kernel_i_equals_the_plain_route_on_the_card(card, k, hyps, use_type):
    """Kernel I against ``_pair_stats`` + ``sample_hypotheses`` on the same
    card inputs, 3 seeds x P in {1, 3, 40, 512, 1024, 2048, 4050, 4096},
    with padded rows, rejects, pairs without a candidate, tied weights and
    types beyond 0 and 1: every output bit-equal."""
    tool = _sample_tool()
    for seed in tool.SEEDS:
        for pnum in tool.PAIRS:
            r = tool.case(seed, pnum, k, hyps, use_type, card)
            assert tool.ok(r), (seed, pnum, r)


@pytest.mark.card
def test_kernel_i_edge_uniforms_on_the_card(card):
    """u * total rounding up to the total, and u = 0: bit-equal."""
    tool = _sample_tool()
    for seed in tool.SEEDS:
        for pnum in (1, 40, 1024):
            r = tool.edge_uniforms(seed, pnum, card)
            assert tool.ok(r), (seed, pnum, r)


@pytest.mark.card
@pytest.mark.parametrize("k", [32, 64, 128])
def test_kernel_i_scans_equal_torch_cumsum_on_the_card(card, k):
    tool = _sample_tool()
    assert {rows: tool.scan_check(rows, k, card)
            for rows in tool.SCAN_ROWS} == dict.fromkeys(tool.SCAN_ROWS, 0)


@pytest.mark.card
def test_match_pairs_batch_launches_kernel_i_once(card):
    assert _sample_tool().launches_per_call(card) == {
        "sample": 1, "match": 1, "finish": 1}


@pytest.mark.card
def test_a_second_match_call_makes_no_synchronising_call(card):
    assert _sample_tool().second_call_syncs(card) == ""


@pytest.mark.card
def test_identify_through_kernel_i_equals_the_plain_route(card):
    r = _sample_tool().identify_against_plain(card)
    assert r["differ"] == 0 and r["mates_top1"] == 3, r


# --- kernel J, the screen's recall anchors ------------------------------------

SCREEN_P = dict(ransac_iter=SCREEN_ITERS, full_iters=H_FULL, min_inliers=6)


def _j_emulated(a, b, wa, wb, reject, p, rescan_ties=True):
    """Kernel J's search, emulated step by step in float32 on the CPU: the
    anchors by a rank count; each valid A slot's distances in the matmul
    form with fma(-2, ab, aa); the quantization by a saturated product with
    2^-10 and + 48; the integer key over the valid B slots only (in their
    order, so a slot's index orders like its compacted position); one
    candidate at the twin's 1e9 under the lowest invalid index for all
    invalid slots; `q >= 2^18 - 1 -> (2^18 - 1, 0)`; and where the twin's
    float key q * K + j rounds (K = 128, q >= 2^17) and the gate could pass,
    the twin's float keys with first-index ties."""
    pnum, k = a.valid.shape
    n = min(8, k)
    idx = torch.arange(k)

    def ranks(ms, w):
        key = torch.where(ms.valid, w, -1.0)
        kj, ki = key[:, None, :], key[:, :, None]
        lower = idx[None, None, :] < idx[None, :, None]
        ahead = torch.where(kj.isnan(), ~ki.isnan() | lower,
                            ~ki.isnan() & ((kj > ki) | ((kj == ki) & lower)))
        return torch.argsort(ahead.sum(dim=-1), dim=-1)[:, :n]

    sa, sb = ranks(a, wa), ranks(b, wb)
    theta = tr._angle_diff(tr._take(b.orientation, sb),
                           tr._take(a.orientation, sa))              # (P, T)
    c, s = tr._cos_sin(theta)
    xa, xb = tr._take(a.xy, sa), tr._take(b.xy, sb)
    rx = tr._fma(c, xa[..., 0], -(s * xa[..., 1])) + 0.0
    ry = tr._fma(s, xa[..., 0], c * xa[..., 1]) + 0.0
    tx, ty = xb[..., 0] - rx, xb[..., 1] - ry
    ok = tr._take(a.valid, sa) & tr._take(b.valid, sb)
    ax, ay = a.xy[:, None, :, 0], a.xy[:, None, :, 1]                # (P, 1, K)
    c3, s3 = c[..., None], s[..., None]
    px = tr._fma(c3, ax, -(s3 * ay)) + tx[..., None]                 # (P, T, K)
    py = tr._fma(s3, ax, c3 * ay) + ty[..., None]
    aa = tr._fma(py, py, px * px)
    bx, by = b.xy[:, None, None, :, 0], b.xy[:, None, None, :, 1]
    bb = tr._fma(by, by, bx * bx)
    ab = tr._fma(py[..., None], by, px[..., None] * bx)             # (P, T, K, K)
    d2 = tr._fma(torch.full_like(ab, -2.0), ab, aa[..., None]) + bb
    v = torch.clamp(d2 * 2.0 ** -10, 0.0, 1.0) + 48.0
    q_all = v.view(torch.int32).to(torch.int64) - 0x42400000        # <= 2^18
    key = torch.where(b.valid[:, None, None, :], q_all * 256 + idx, 2 ** 40)
    best = key.min(dim=-1).values
    q, j = best // 256, best % 256
    sat = 2 ** 18 - 1
    first_invalid = torch.where(b.valid.all(dim=-1), k,
                                torch.argmin(b.valid.to(torch.uint8), dim=-1))
    fi = first_invalid[:, None, None].expand_as(q)
    take = (fi < k) & ((sat < q) | ((sat == q) & (fi < j)))
    q, j = torch.where(take, sat, q), torch.where(take, fi, j)
    qc = torch.clamp(q, max=sat)
    d_c = torch.sqrt(qc.to(torch.float32) * 0.00390625)
    rescan = (qc * k + (k - 1) >= 2 ** 24) & (d_c <= p.dist_thresh)
    rescan &= rescan_ties
    if bool(rescan.any()):
        qq = torch.where(b.valid[:, None, None, :], torch.clamp(q_all, max=sat),
                         sat).to(torch.float32)
        code = qq * float(k) + idx.to(torch.float32)
        cmin, cj = torch.min(code, dim=-1)
        q = torch.where(rescan, torch.floor(cmin / float(k)).to(torch.int64), q)
        j = torch.where(rescan, cj, j)
    fix = ~rescan & (q >= sat)
    q, j = torch.where(fix, sat, q), torch.where(fix, 0, j)
    d = torch.sqrt(q.to(torch.float32) * 0.00390625)
    ang = torch.abs(tr._angle_diff(a.orientation[:, None] + theta[..., None],
                                   tr._take(b.orientation, j)))
    inl = a.valid[:, None] & (d <= p.dist_thresh) & (ang <= p.orient_thresh)
    if p.use_type:
        inl &= a.minutia_type[:, None] == tr._take(b.minutia_type, j)
    counts = inl.sum(dim=-1)
    return ((ok & (counts >= p.min_inliers)).any(dim=-1) & ~reject, inl,
            dict(rescan=int(rescan.sum()), stand_in=int(take.sum()),
                 saturated=int(fix.sum())))


def _float_key_tie():
    """A K = 128 pair whose twin takes B slot 0 where the exact key takes
    slot 127: A's 8 weightiest minutiae on a circle of 60 px about (100,
    100) and a bifurcation at its centre; B the circle's copies in slots 1
    to 8, a bifurcation 22.6276 px above the centre in slot 0 (q = 2^17 + 2)
    and an ending 22.6275 px right of it in slot 127 (q = 2^17 + 1). Every
    anchor is the identity, and the twin's float keys tie at
    (2^17 + 2) * 128: q * 128 + 127 rounds up to it, and the first index
    wins. With min_inliers 9 the centre decides: the twin promotes the
    pair, the exact key would not."""
    k, c = 128, 100.0
    ang = np.arange(8) * (np.pi / 4)
    ring = np.stack([c + 60 * np.cos(ang), c + 60 * np.sin(ang)], -1)
    q_ring = np.linspace(0.9, 0.55, 8)

    def tmpl(slots):
        d = dict(xy=np.zeros((1, k, 2), np.float32),
                 orientation=np.full((1, k), 0.3, np.float32),
                 minutia_type=np.zeros((1, k), np.int32),
                 quality=np.zeros((1, k), np.float32),
                 valid=np.zeros((1, k), bool))
        for i, (xy, ty, q) in slots.items():
            d["xy"][0, i], d["minutia_type"][0, i] = xy, ty
            d["quality"][0, i], d["valid"][0, i] = q, True
        d["coherence"] = d["angular_stability"] = d["quality"]
        return minutiae_from_numpy(d)

    a = tmpl({**{i: (ring[i], 0, q_ring[i]) for i in range(8)},
              8: ((c, c), 1, 0.41)})
    b = tmpl({**{i + 1: (ring[i], 0, q_ring[i]) for i in range(8)},
              0: ((c, c + 22.627605438232422), 1, 0.4),
              127: ((c + 22.62749671936035, c), 0, 0.4)})
    return a, b, tr.MatchParams(**{**SCREEN_P, **FRR_GATES, "min_inliers": 9})


def _j_sets(case):
    """(A, B, MatchParams) of the CPU cases of kernel J's arithmetic."""
    if case == "K=128, float-key tie":
        return _float_key_tie()
    if case == "weak templates":
        a, b = _weak_templates()
        return (minutiae_from_numpy(a), minutiae_from_numpy(b),
                tr.MatchParams(**SCREEN_P))
    if case.startswith("rigid"):
        k = int(case.split("K=")[1].split(",")[0])
        (_, ta), (_, tb) = _rigid_pairs(5, pnum=12, k=k, n=min(40, k),
                                        impostors=6)
        p = tr.MatchParams(**{**SCREEN_P, **(FRR_GATES if "FRR" in case
                                             else {})})
        return ta, tb, p
    (_, ta), (_, tb) = _rigid_pairs(9, pnum=12, impostors=6)
    g = torch.Generator().manual_seed(3)
    if case == "scattered validity, no valid B":
        keep = lambda v: v & (torch.rand(v.shape, generator=g) < 0.7)
        ta, tb = ta._replace(valid=keep(ta.valid)), tb._replace(valid=keep(tb.valid))
        tb.valid[2] = False
        tb.valid[3, 9:] = False                  # fewer than 8 valid
        ta.quality[4] = 0.7                      # tied weights
        ta.coherence[4] = 0.7
        ta.angular_stability[4] = 0.7
        ta.minutia_type[4] = 0
        return ta, tb, tr.MatchParams(**SCREEN_P)
    # far from the origin: |a|^2 and |b|^2 near 6e8, an ulp of 64 px^2
    off = torch.tensor([20000.0, -15000.0] if case.endswith("20,000")
                       else [3000.0, 2000.0])
    return (ta._replace(xy=ta.xy + off), tb._replace(xy=tb.xy + off),
            tr.MatchParams(**SCREEN_P))


J_CPU_CASES = ["weak templates", "rigid, K=64", "rigid, K=32",
               "rigid, K=128", "rigid, K=128, FRR gates",
               "K=128, float-key tie", "scattered validity, no valid B",
               "offset 3,000", "offset 20,000"]


@pytest.mark.parametrize("case", J_CPU_CASES)
def test_kernel_j_search_emulated_equals_the_twin(case):
    """Kernel J's search, emulated in float32 on the CPU (``_j_emulated``),
    gives the twin's promote bits and every A slot's inlier flag under
    every anchor on every case: the weak-template anchors,
    rigid genuine and impostor pairs at K = 32, 64 and 128 (at K = 128
    under FRR gates the twin's float keys round and the rescan runs; on the
    float-key tie of ``_float_key_tie`` only the rescan gives the twin's
    bit),
    scattered validity with a template without a valid B slot, one with
    fewer than 8 and tied weights, and coordinates 3,600 and 25,000 px from
    the origin."""
    a, b, p = _j_sets(case)
    args = (a, b, *_j_stats(a, b), p)
    want = tr._anchor_promote(*args)
    got, inl, seen = _j_emulated(*args)
    assert torch.equal(got, want), (case, seen)
    assert torch.equal(inl, tr._anchor_inliers(a, b, *args[2:4], p)[1]), (
        case, seen)
    if case == "rigid, K=128, FRR gates":
        assert seen["rescan"] > 0, seen
    if case == "K=128, float-key tie":
        assert want.tolist() == [True] and seen["rescan"] == 8, seen
        assert _j_emulated(*args, rescan_ties=False)[0].tolist() == [False]
    if case == "scattered validity, no valid B":
        assert seen["stand_in"] > 0 and seen["saturated"] > 0, seen
    if case in ("rigid, K=64", "weak templates"):
        assert 0 < int(want.sum()) < len(want)


def _j_stats(a, b):
    wa, wb, _, _, _, reject = tr._pair_stats(a, b)
    return wa, wb, reject


def test_kernel_j_quantization_is_the_twins():
    """fma(-2, ab, aa) is the twin's aa - 2.0 * ab (2 ab is exact), and
    the saturated product with 2^-10 plus 48.0 leaves min(rint(max(d2, 0)
    * 256), 2^18) in the low mantissa bits, whose minimum with 2^18 - 1 is
    the twin's quantized distance, for every half step of d2 in [0, 1024]
    with its neighbours, negatives and values far beyond."""
    x = _rounding_inputs() / 256.0                      # d2, exact
    x = torch.cat([x, -x[:1000], torch.tensor([0.0, -0.0, 1e-40, -1e-40])])
    want = torch.clamp(torch.round(torch.clamp(x, min=0.0) * 256.0), max=_S)
    v = torch.clamp(x * 2.0 ** -10, 0.0, 1.0) + 48.0
    assert v.dtype == torch.float32
    q = v.view(torch.int32) - 0x42400000
    assert int(q.min()) == 0 and int(q.max()) == 2 ** 18
    np.testing.assert_array_equal(torch.clamp(q, max=2 ** 18 - 1).numpy(),
                                  want.numpy().astype(np.int32))
    g = np.random.default_rng(31)
    aa, ab = (torch.from_numpy(g.uniform(-3e8, 3e8, 200_000).astype(np.float32))
              for _ in range(2))
    got = tr._fma(torch.full_like(ab, -2.0), ab, aa)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  (aa - 2.0 * ab).numpy().view(np.uint32))


def test_kernel_j_rank_count_is_the_stable_sort():
    """The anchors' order, a rank count with NaN ahead of every number and
    ties to the lower index, is ``torch.sort(descending=True, stable=True)``'s
    on keys with ties, NaN, -1 for invalid slots and 0.0 against -0.0."""
    g = torch.Generator().manual_seed(5)
    key = torch.randint(0, 6, (64, 64), generator=g).to(torch.float32) / 4
    key[key == 1.25] = -1.0
    key[::7, ::5] = float("nan")
    key[1::3, ::11] = -0.0
    idx = torch.arange(64)
    kj, ki = key[:, None, :], key[:, :, None]
    lower = idx[None, None, :] < idx[None, :, None]
    ahead = torch.where(kj.isnan(), ~ki.isnan() | lower,
                        ~ki.isnan() & ((kj > ki) | ((kj == ki) & lower)))
    order = torch.argsort(ahead.sum(dim=-1), dim=-1)
    want = torch.sort(key, dim=-1, descending=True, stable=True).indices
    assert torch.equal(order, want)


def test_anchor_pairs_sends_cpu_tensors_to_the_plain_twin(monkeypatch):
    """The anchors' dispatcher runs ``ransac._anchor_promote`` on CPU
    tensors, unchanged, inside the span ``match.anchor``, and launches
    nothing: ``kernel.anchor`` stays 0."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import profiling
    calls = []
    shipped = tcm._anchor_promote

    def spy(*args):
        calls.append((profiling._stack()[-1].name, args[0].xy.device))
        return shipped(*args)

    monkeypatch.setattr(tcm, "_anchor_promote", spy)
    a, b, p = _j_sets("rigid, K=64")
    stats = _j_stats(a, b)
    before = build.launches()
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = tcm.anchor_pairs(a, b, *stats, p)
    profiling.clear()
    assert calls == [("match.anchor", torch.device("cpu"))]
    assert build.launches() == before and before["anchor"] == 0
    want = tr.anchor_promote(a, b, p)
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert 0 < int(want.sum()) < len(want)


@pytest.mark.parametrize("case", ["cpu", "meta", "k48", "k256", "shapes",
                                  "reject"])
def test_anchor_pairs_cuda_refuses_what_kernel_j_does_not_take(case):
    """Kernel J's wrapper raises on a CPU or other non-CUDA tensor, on K
    not a power of two or over 128 and on shapes that do not fit one
    another (the weights' or the early reject's), before it launches
    anything; the dispatcher raises on a non-CUDA, non-CPU device."""
    before = build.launches()
    dev = "cpu" if case == "cpu" else "meta"
    a, b = _sample_pairs_input(dev, pnum=4, k=64 if case[0] == "k" else 32)
    wa, wb = torch.zeros_like(a.quality), torch.zeros_like(b.quality)
    reject = torch.zeros_like(a.valid[:, 0])
    match = "CUDA tensor"
    if case[0] == "k":
        k = int(case[1:])
        grow = lambda x: torch.zeros(x.shape[:1] + (k,) + x.shape[2:],
                                     dtype=x.dtype, device="meta")
        a, b = tr.MinutiaeSet(*map(grow, a)), tr.MinutiaeSet(*map(grow, b))
        wa, wb = grow(wa), grow(wb)
        match = "power of two"
    elif case == "shapes":
        wb = wb[:, :-1]                                  # one slot short
        match = "inconsistent"
    elif case == "reject":
        reject = reject[:-1]                             # one pair short
        match = "inconsistent"
    p = tr.MatchParams(**SCREEN_P)
    with pytest.raises(ValueError, match=match):
        tcm.anchor_pairs_cuda(a, b, wa, wb, reject, p)
    if case == "meta":
        with pytest.raises(ValueError, match="CUDA tensor"):
            tcm.anchor_pairs(a, b, wa, wb, reject, p)
    assert build.launches() == before


def test_screen_promote_batch_computes_the_statistics_once(monkeypatch):
    """A screen call samples once and hands the weights and the early
    reject to the anchors: ``_pair_stats`` runs once a call (it ran twice
    before, once in the sampling and once in ``anchor_promote``), and the
    promote bits are the sampled screen's OR the anchors'."""
    seen = []
    for mod in (tcm, tr):
        shipped = mod._pair_stats

        def spy(*args, _f=shipped):
            seen.append(args[0].valid.shape)
            return _f(*args)

        monkeypatch.setattr(mod, "_pair_stats", spy)
    (_, ta), (_, tb) = _rigid_pairs(3, pnum=8, impostors=4)
    p = tr.MatchParams(**SCREEN_P)
    got = tcm.screen_promote_batch(ta, tb, p)
    assert seen == [(8, 64)]
    base = tcm.screen_promote_batch(ta, tb, p, anchors=False)
    anchors = tr.anchor_promote(ta, tb, p)
    assert len(seen) == 3
    assert torch.equal(got, base | anchors)


@pytest.mark.parametrize("case", ["weak templates", "rigid, K=64",
                                  "scattered validity, no valid B"])
def test_plain_twin_fed_kernel_i_statistics_equals_anchor_promote(case):
    """The twin fed the statistics ``sample_pairs`` returns (kernel I's on
    a card, here its plain route) equals ``anchor_promote(a, b, p)``, which
    computes its own."""
    a, b, p = _j_sets(case)
    wa, wb, _, _, _, reject, *_ = tcm.sample_pairs(a, b, p)
    got = tr._anchor_promote(a, b, wa, wb, reject, p)
    assert torch.equal(got, tr.anchor_promote(a, b, p))


J_CARD_CASES = ["tile, K=64", "tile, K=32", "tile, K=128",
                "tile, K=128, FRR gates", "P=1", "P=333", "P=4,096",
                *J_CPU_CASES]


def _j_plain(a, b, wa, wb, reject, p, chunk=512):
    """The twin, ``chunk`` pairs at a time (each pair's bit is its own),
    which bounds its float64 (pairs, 8, K, K) temporaries on the card."""
    cut = lambda x, s: x[s:s + chunk]
    return torch.cat([tr._anchor_promote(
        tr.MinutiaeSet(*(cut(x, s) for x in a)),
        tr.MinutiaeSet(*(cut(x, s) for x in b)),
        cut(wa, s), cut(wb, s), cut(reject, s), p)
        for s in range(0, a.valid.shape[0], chunk)])


def _j_card_inputs(gallery, dev, case):
    """(A, B, MatchParams) of a kernel J card case, on ``dev``."""
    from torch_card import anchor_tile
    ds, pairs, many = gallery
    p = tr.MatchParams(**SCREEN_P)
    if case.startswith("tile"):
        k = int(case.split("K=")[1].split(",")[0])
        a, b = anchor_tile(ds, first=k // 8, k=k)
        return a, b, (p._replace(**{**FRR_GATES, "min_inliers": 4})
                      if "FRR" in case else p)
    if case.startswith("P="):
        n = int(case[2:].replace(",", ""))
        idx = (many if n > len(pairs) else pairs)[:n]
        return trun._gather(ds, idx[:, 0]), trun._gather(ds, idx[:, 1]), p
    a, b, p = _j_sets(case)
    move = lambda ms: tr.MinutiaeSet(*(x.to(dev) for x in ms))
    return move(a), move(b), p


@pytest.mark.card
@pytest.mark.parametrize("case", J_CARD_CASES)
def test_kernel_j_equals_the_plain_anchors_on_the_card(d_gallery, card, case):
    """Kernel J against ``_anchor_promote`` fed the same statistics (kernel
    I's) on the card: screen tiles of 4,096 pairs of the card tests'
    gallery at K = 32, 64 and 128 (at 128 also under FRR gates, where the
    twin's float keys round), 1, 333 and 4,096 of its pairs, and the CPU
    cases: the weak templates, rigid pairs, the float-key tie, scattered
    validity with no valid B slot, fewer than 8 minutiae and tied weights,
    and coordinates 3,600 and 25,000 px from the origin. The promote bits
    are equal (J_MAX_MISMATCH), one launch a call."""
    from torch_card import J_MAX_MISMATCH, anchor_args
    a, b, p = _j_card_inputs(d_gallery, card, case)
    args = anchor_args(a, b, p)
    before = build.launches()["anchor"]
    got = tcm.anchor_pairs_cuda(*args)
    torch.cuda.synchronize()
    assert build.launches()["anchor"] == before + 1
    want = _j_plain(*args)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert int((got != want).sum()) <= J_MAX_MISMATCH, (
        case, int((got != want).sum()), int(want.sum()))
    if case == "K=128, float-key tie":
        assert got.tolist() == [True]
    if case.startswith("tile") or case == "P=4,096":
        assert 0 < int(want.sum()) < len(want)


@pytest.mark.card
def test_screen_launches_kernel_j_once_and_its_mask_is_the_plain_routes(
        card, monkeypatch):
    """A ``screen_promote_batch`` call on the card launches I, D and J once
    each; ``shard_blocks_screen`` over a 256-template gallery gives the mask
    it gives with the plain anchors in J's place."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
        gallery as tg)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
        users_gallery)
    gal = minutiae_from_numpy(users_gallery(128, 2, k=64, seed=3), card)
    p = tr.MatchParams(**SCREEN_P)
    a = tg.take_templates(gal, torch.arange(64).repeat_interleave(64))
    b = tg.take_templates(gal, torch.arange(64, 128).repeat(64))
    before = build.launches()
    tcm.screen_promote_batch(a, b, p)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in build.launches().items()
             if c != before[n]}
    assert moved == {"sample": 1, "match": 1, "anchor": 1}
    mesh = create_mesh()
    bp, mask = tg.shard_blocks_screen(gal, mesh, p)
    monkeypatch.setattr(tcm, "anchor_pairs_cuda", _j_plain)
    bp_plain, mask_plain = tg.shard_blocks_screen(gal, mesh, p)
    np.testing.assert_array_equal(bp, bp_plain)
    np.testing.assert_array_equal(mask, mask_plain)
    assert 0 < int(mask.sum()) < mask.size
