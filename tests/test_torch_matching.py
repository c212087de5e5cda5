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
from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
    cuda_match as tcm, dataset as tds, ransac as tr, runner as trun)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import io as tio

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures" / "parity"
FRR_GATES = dict(dist_thresh=30.0, orient_thresh=math.radians(30.0),
                 min_inliers=6)
FAR_GATES = dict(dist_thresh=15.0, orient_thresh=math.radians(10.0),
                 min_inliers=12)


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
    base = tcm.screen_pairs_batch_kernel(ta, tb, tp).numpy()
    np.testing.assert_array_equal(
        base, _np(jpm.screen_pairs_batch_pallas(ja, jb, jp, interpret=True)))
    np.testing.assert_array_equal(
        tcm.screen_promote_batch(ta, tb, tp, anchors=False).numpy(), base)


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
    """csrc/match.cu wraps the orientation difference without fmodf where
    the quotient is 0 or 1: v below 2 pi, v -+ 2 pi below 4 pi (an exact
    float subtraction), fmodf beyond. In float32 that is the twin's
    |remainder(x + pi, 2 pi) - pi| bit for bit."""
    src = CSRC.read_text()
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
