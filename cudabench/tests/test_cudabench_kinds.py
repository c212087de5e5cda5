"""Each kind of work on the CPU at a tiny size, through the
harness but not through ``run.py`` (which refuses the CPU): the step runs,
the program's CPU route agrees with the frozen reference, a traced run
reads its trace, and a run with the timed path broken underneath comes out
not correct."""

import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cudabench import harness
from cudabench.kinds.common import no_span
from cudabench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 11          # seeds run past 32 signed bits
CELLS = ["polyu_hrf_dbii.enrol", "nist_sd4.identify", "polyu_hrf_dbii.all_pairs"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, program=None, trace=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.2, trace, CPU, time.perf_counter(), program)


def test_one_step_of_each_mix():
    for name in CELLS:
        c = tiny_cell(name)
        mod = harness.kind_module(c)
        drv = mod.Work(c.config, c.traffic, SEED, CPU, mod.program())
        if c.traffic["kind"] == "enrol":
            mask, skel, mat, valid = drv._step(0, no_span)
            assert mask.shape == skel.shape == (2, 128, 96)
            assert mat.shape == (2, 64, 7) and valid.any()
        elif c.traffic["kind"] == "identify":
            s = drv._call(drv.order[0])
            assert s.shape == (8,) and float(s.max()) > 0     # the mate scores
        else:
            s = drv._sweep(drv.galleries[0])
            assert s.shape == (66,) and (s > 0).sum() >= 4


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    out = _run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values()), out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    e2e = set(out["metrics"])
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_spans_and_leaves_device_metrics_out(name):
    out = _run(tiny_cell(name), trace=True)
    assert out["correct"]
    got = set(out["metrics"])
    # no device operation on the CPU: no roofline, idle or op count
    assert not any("roofline" in m or "idle" in m or "ops_per" in m for m in got)
    if name.endswith("enrol"):
        assert {"enhance_ms.enrol", "features_ms.enrol"} <= got
    if name.endswith("all_pairs"):
        assert {"screen_ms.all_pairs", "promoted_pct.all_pairs"} <= got
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_comparison_is_not_trivial():
    """The checked outputs hold what the limits are about: minutiae in the
    enrol batch, scores above 0 in the matcher cells."""
    c = tiny_cell("polyu_hrf_dbii.enrol")
    mod = harness.kind_module(c)
    drv = mod.Work(c.config, c.traffic, SEED, CPU, mod.program())
    drv.warm_up()
    drv.window(0.1, harness.Spans(CPU, False))
    drv.release()
    assert drv.prog[3].sum() > 0 and drv.prog[1].sum() > 100
    c = tiny_cell("nist_sd4.identify")
    mod = harness.kind_module(c)
    drv = mod.Work(c.config, c.traffic, SEED, CPU, mod.program())
    drv.window(0.1, harness.Spans(CPU, False))
    drv.release()
    assert all(s.max() > 0 for _, s in drv.checked)
    c = tiny_cell("polyu_hrf_dbii.all_pairs")
    mod = harness.kind_module(c)
    drv = mod.Work(c.config, c.traffic, SEED, CPU, mod.program())
    drv.window(0.1, harness.Spans(CPU, False))
    drv.release()
    assert (drv.checked[2] > 0).sum() >= 4


# ---- faults planted in the timed path: each must come out not correct ----

def _lagged(fn):
    """A step that returns its state unchanged: each call returns the
    previous call's result."""
    box = []

    def call(*a, **k):
        box.append(fn(*a, **k))
        return box[-2] if len(box) > 1 else box[-1]
    return call


def _enrol_faults(p):
    def half(x, **k):
        """Half of the batch left out, its place taken by the rest."""
        res = p.preprocess(x[: x.shape[0] // 2], **k)
        return type(res)(*(torch.cat([v, v]) for v in res))

    def altered(ms, skel, **k):
        """An answer altered where it is produced: every image's first
        minutia turned by 0.5 rad, twice the orientation limit."""
        out = p.postprocess(ms, skel, **k)
        ori = out.orientation.clone()
        ori[:, 0] += 0.5
        return out._replace(orientation=ori)
    return {"state_unchanged": dict(preprocess=_lagged(p.preprocess)),
            "half_the_batch": dict(preprocess=half),
            "answer_altered": dict(postprocess=altered)}


def _identify_faults(p):
    def half(probe, gallery, *a, **k):
        s = p.identify(probe, gallery, *a, **k)
        return torch.cat([s[: len(s) // 2], torch.zeros_like(s[len(s) // 2:])])

    def altered(*a, **k):
        s = p.identify(*a, **k).clone()
        s[s.argmax()] += 0.01
        return s
    return {"state_unchanged": dict(identify=_lagged(p.identify)),
            "half_the_batch": dict(identify=half),
            "answer_altered": dict(identify=altered)}


def _all_pairs_faults(p):
    def half(*a, **k):
        s = p.all_pairs_unique(*a, **k).copy()
        s[len(s) // 2:] = 0.0
        return s

    def altered(*a, **k):
        s = p.all_pairs_unique(*a, **k).copy()
        s[s > 0] += 0.01
        return s
    return {"state_unchanged": dict(all_pairs_unique=_lagged(p.all_pairs_unique)),
            "half_the_batch": dict(all_pairs_unique=half),
            "answer_altered": dict(all_pairs_unique=altered)}


FAULTS = {"enrol": _enrol_faults, "identify": _identify_faults,
          "all_pairs": _all_pairs_faults}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    c = tiny_cell(name)
    mod = harness.kind_module(c)
    p = mod.program()
    broken = SimpleNamespace(**{**vars(p), **FAULTS[c.traffic["kind"]](p)[fault]})
    out = _run(c, broken)
    assert not out["correct"], out["checks"]


def test_a_sweep_returning_the_last_sweeps_scores_is_not_correct():
    """Consecutive sweeps take different galleries: a sweep that returns
    the sweep before it fails on scores, not only on the warm-up's length."""
    c = tiny_cell("polyu_hrf_dbii.all_pairs")
    mod = harness.kind_module(c)
    p = mod.program()
    broken = SimpleNamespace(**{**vars(p), "all_pairs_unique": _lagged(p.all_pairs_unique)})
    drv = mod.Work(c.config, c.traffic, SEED, CPU, broken)
    drv.warm_up()
    while drv.sweeps < 2:
        drv.window(0.01, harness.Spans(CPU, False))
    assert drv.last_gallery != (drv.sweeps - 2) % c.traffic["distinct_galleries"]
    drv.release()
    gap = drv.compare()["score_gap"]
    assert 1e-3 < gap < float("inf")


def test_run_py_refuses_a_machine_without_a_card():
    res = subprocess.run(
        [sys.executable, str(ROOT / "cudabench" / "run.py"), "--workload",
         "polyu_hrf_dbii.enrol", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_judge_holds_every_number_to_its_limit():
    ok, checks = harness.judge({"a": 0.5, "b": float("nan")}, {"a": 1.0, "b": 1.0})
    assert not ok and checks["a"] == {"value": 0.5, "limit": 1.0}
    ok, _ = harness.judge({"a": 0.5}, {"a": 1.0, "c": 1.0})
    assert not ok
    ok, _ = harness.judge({"a": 1.0}, {"a": 1.0})
    assert ok
