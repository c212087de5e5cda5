"""The candidate-list search (``kinds/identify_candidates.py``) on the CPU at
tiny sizes of its own, for both of its mixes: the cascade over a gallery of
one impression a finger, and the exhaustive search over every impression
with padding rows. Through the harness but not through ``run.py`` (which
refuses the CPU): the program agrees with the frozen reference, the
control does not, and a timed path broken underneath comes out not
correct."""

import copy
import time
from types import SimpleNamespace

import pytest
import torch

from cudabench import calibrate, harness

CPU = torch.device("cpu")
SEED = 2 ** 31 + 29          # seeds run past 32 signed bits
WINDOW_S = 1.0              # tens of calls here; a loaded host runs fewer
CASCADE = "nist_sd14_cascade.identify_candidates"
EXHAUSTIVE = "polyu_hrf_dbii.identify_batch"


def tiny_cell(name: str) -> harness.Cell:
    """12 probes in calls of 4, every one checked, lists of 5. The cascade
    cell: 12 fingers, one enrolled, a screen of 4 hypotheses against a full
    pass of 40 at min_inliers 5, where the full pass scores impostor pairs
    the screen does not promote (so a skipped screen shows). The
    exhaustive cell: 6 fingers x 3 enrolled, 18 rows padded to 20."""
    c = copy.deepcopy(harness.load_cell(name))
    c.config["frame"] = {"height": 120, "width": 96}
    c.config["match"].update(ransac_iter=40, min_inliers=5)
    c.config["templates"] = {"k": 16, "n_min": 12}
    c.traffic.update(probes_per_call=4, candidates=5, check_probes=12,
                     profiled_calls=1)
    if c.traffic["cascade"]:
        c.config["gallery"] = {"fingers": 12, "impressions": 2, "enrolled": 1}
        c.traffic.update(probe_impressions=1, chunk=3, screen_iters=4)
    else:
        c.config["gallery"] = {"fingers": 6, "impressions": 3}
        c.traffic.update(probe_impressions=2, chunk=4)
    return c


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, program=None, trace=False):
    return harness.run_cell(cell, SEED, WINDOW_S, trace, CPU, time.perf_counter(),
                            program)


@pytest.mark.parametrize("name", [CASCADE, EXHAUSTIVE])
def test_reference_agrees_with_the_port_on_the_cpu(name):
    out = _run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["checks"]["score_gap"]["value"] == 0.0
    assert out["checks"]["candidate_mismatch"]["value"] == 0
    assert out["attempted"] >= 12 and out["attempted"] % 4 == 0
    assert set(out["metrics"]) == {"identify_p95_ms", "identify_probes_per_s",
                                   "setup_s"}


@pytest.mark.parametrize("name", [CASCADE, EXHAUSTIVE])
def test_the_comparison_is_not_trivial(name):
    """Every probe is checked; the mates head most lists, and the
    exhaustive lists hold several mates and a -1 tail."""
    c = tiny_cell(name)
    mod = harness.kind_module(c)
    drv = mod.Work(c.config, c.traffic, SEED, CPU, mod.program())
    drv.warm_up()
    while len(drv.seconds) < 3:
        drv.window(0.01, harness.Spans(CPU, False))
    drv.release()
    assert len(drv.checked) == 12
    assert drv.mates["mate_rank1_pct"] >= 75.0
    heads = [ids[0] for _, ids, _ in drv.checked]
    assert sum(h >= 0 for h in heads) >= 9
    assert all((ids == -1).any() for _, ids, _ in drv.checked)
    if name == EXHAUSTIVE:
        assert max(int((ids >= 0).sum()) for _, ids, _ in drv.checked) >= 3
        assert all(ids.max() < 18 for _, ids, _ in drv.checked)


@pytest.mark.parametrize("name", [CASCADE, EXHAUSTIVE])
def test_traced_run_reads_the_counters_and_no_device_metric(name):
    out = _run(tiny_cell(name), trace=True)
    assert out["correct"]
    got = set(out["metrics"])
    assert not any("roofline" in m or "idle" in m or "stream" in m for m in got)
    assert got == ({"promoted_pct.identify_candidates"} if name == CASCADE else set())
    if name == CASCADE:
        assert 0 < out["metrics"]["promoted_pct.identify_candidates"]["value"] < 100
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0


@pytest.mark.parametrize("name", [CASCADE, EXHAUSTIVE])
def test_control_fails_on_the_cpu(name):
    cell = tiny_cell(name)
    prog = calibrate.readings(cell, SEED, WINDOW_S, CPU)
    ctl = calibrate.readings(cell, SEED, WINDOW_S, CPU, "bf16")
    assert harness.judge(prog["numbers"], cell.limits)[0]
    assert not harness.judge(ctl["numbers"], cell.limits)[0], ctl


# ---- faults planted in the timed path: each must come out not correct ----

def _broken(p, fault: str) -> SimpleNamespace:
    """The kind's program with ``fault`` planted: the screen skipped in
    ``identify_batch``, or the lists spoiled after ``candidate_list``."""
    last = []

    def identify_batch(*args, **kw):
        kw["cascade"] = False
        return p.identify_batch(*args, **kw)

    def candidate_list(scores, length):
        ids, top = (x.clone() for x in p.candidate_list(scores, length))
        if fault == "previous_lists":
            last.append((ids, top))
            return last[-2] if len(last) > 1 else last[-1]
        if fault == "ids_swapped":
            ids[:, [0, 1]] = ids[:, [1, 0]]
        elif fault == "score_raised":
            top[0, 0] += 0.01
        elif fault == "mate_dropped":       # the head of each list, the mate
            ids = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -1)], 1)
            top = torch.cat([top[:, 1:], torch.zeros_like(top[:, :1])], 1)
        return ids, top

    swap = ({"identify_batch": identify_batch} if fault == "screen_skipped"
            else {"candidate_list": candidate_list})
    return SimpleNamespace(**{**vars(p), **swap})


FAULTS = ["previous_lists", "ids_swapped", "score_raised", "mate_dropped"]


@pytest.mark.parametrize("name,fault", [(CASCADE, f) for f in FAULTS + ["screen_skipped"]]
                         + [(EXHAUSTIVE, f) for f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault):
    c = tiny_cell(name)
    out = _run(c, _broken(harness.kind_module(c).program(), fault))
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", [CASCADE, EXHAUSTIVE])
def test_control_fails_at_the_cells_own_size(name):
    if not torch.cuda.is_available():
        pytest.skip("the cell runs on a CUDA card")
    cell = harness.load_cell(name)
    dev = torch.device("cuda", 0)
    prog = calibrate.readings(cell, SEED, 2.0, dev)
    ctl = calibrate.readings(cell, SEED, 2.0, dev, "bf16")
    assert harness.judge(prog["numbers"], cell.limits)[0], prog
    assert not harness.judge(ctl["numbers"], cell.limits)[0], ctl
