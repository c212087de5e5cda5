"""The sharded identification cell (``kinds/identify_batch.py``) on the CPU
at a tiny size of its own: two gloo ranks, 12 fingers, chunk 3, 4 probes a
call, through the harness but not through ``run.py`` (which refuses the
CPU). The program agrees with the frozen reference, the control does not,
and a timed path broken underneath comes out not correct. At the cell's
own size the control runs on four cards (marked ``card``)."""

import copy
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cudabench import calibrate, harness

ROOT = Path(__file__).resolve().parents[2]
CELL = "nist_sd14.identify_batch.x4"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 23          # seeds run past 32 signed bits
WINDOW_S = 1.0              # about 30 calls here; a loaded host runs fewer


def tiny_cell() -> harness.Cell:
    """The cell at 12 fingers on two ranks: 6 rows a rank, two chunks of
    3; every probed finger and every row compared; frames, templates and
    hypotheses as the other kinds' tiny cells."""
    c = copy.deepcopy(harness.load_cell(CELL))
    c.config["frame"] = {"height": 120, "width": 96}
    c.config["match"]["ransac_iter"] = 40
    c.config["templates"] = {"k": 16, "n_min": 12}
    c.config["gallery"] = {"fingers": 12, "impressions": 2}
    c.traffic.update(probes_per_call=4, ranks=2, chunk=3, check_probes=12,
                     check_rows_per_shard=6, profiled_calls=1)
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


def test_the_mix_asks_for_as_many_ranks_as_the_cell_has_chips():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert harness.load_cell(CELL).traffic["ranks"] == entry["chips"] == 4


def test_reference_agrees_with_the_port_on_the_cpu():
    out = _run(tiny_cell())
    assert out["correct"], out["checks"]
    assert out["checks"]["score_gap"]["value"] == 0.0
    assert out["attempted"] > 0 and out["attempted"] % 4 == 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"identify_p95_ms", "identify_probes_per_s",
                                   "setup_s"}


def test_the_comparison_is_not_trivial():
    """The compared columns hold the mates' scores above 0, of both
    ranks' rows."""
    c = tiny_cell()
    mod = harness.kind_module(c)
    drv = mod.Work(c.config, c.traffic, SEED, CPU, mod.program())
    drv.warm_up()
    while len(drv.seconds) < 3:     # every finger probed
        drv.window(0.01, harness.Spans(CPU, False))
    drv.release()
    assert len(drv.checked) == 12
    mates = [s[i] for i, s in drv.checked]
    assert sum(m > 0 for m in mates) >= len(mates) // 2
    assert {i // 6 for i, s in drv.checked if s[i] > 0} == {0, 1}
    assert all(len(cols) == 12 for cols in drv.columns)


def test_traced_run_reads_no_device_metric_on_the_cpu():
    out = _run(tiny_cell(), trace=True)
    assert out["correct"]
    assert not any("roofline" in m or "idle" in m or "gather" in m
                   for m in out["metrics"])
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0


def test_control_fails_on_the_cpu():
    cell = tiny_cell()
    prog = calibrate.readings(cell, SEED, WINDOW_S, CPU)
    ctl = calibrate.readings(cell, SEED, WINDOW_S, CPU, "bf16")
    assert harness.judge(prog["numbers"], cell.limits)[0]
    assert not harness.judge(ctl["numbers"], cell.limits)[0], ctl


# ---- faults planted in the timed path: each must come out not correct ----

def _broken(base, fault: str):
    class Broken(base):
        last = None

        def identify_batch(self, probes):
            s = super().identify_batch(probes).clone()
            p, n = s.shape
            if fault == "state_unchanged":
                prev, self.last = self.last, s
                return s if prev is None else prev
            if fault == "half_the_columns":
                s[:, n // 2:] = 0.0
            elif fault == "one_score_altered":
                s.view(-1)[s.argmax()] += 0.01
            else:               # the ranks' blocks gathered in reverse order
                w = self.group.n
                s = s.reshape(p, w, n // w).flip(1).reshape(p, n)
            return s
    return Broken


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_columns",
                                   "one_score_altered", "blocks_reversed"])
def test_a_broken_timed_path_is_not_correct(fault):
    c = tiny_cell()
    p = harness.kind_module(c).program()
    broken = SimpleNamespace(**{**vars(p), "ShardedGallery": _broken(p.ShardedGallery,
                                                                   fault)})
    out = _run(c, broken)
    assert not out["correct"], out["checks"]


@pytest.mark.card
def test_control_fails_at_the_cells_own_size():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("the cell runs on four CUDA cards")
    cell = harness.load_cell(CELL)
    dev = torch.device("cuda", 0)
    prog = calibrate.readings(cell, SEED, 2.0, dev)
    ctl = calibrate.readings(cell, SEED, 2.0, dev, "bf16")
    assert harness.judge(prog["numbers"], cell.limits)[0], prog
    assert not harness.judge(ctl["numbers"], cell.limits)[0], ctl
    limit = cell.limits["score_gap"]
    assert ctl["numbers"]["score_gap"] >= 2 * limit, ctl
