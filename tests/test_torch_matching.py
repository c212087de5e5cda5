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
    cuda_match as tcm, dataset as tds, ransac as tr, runner as trun, threefry)
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
