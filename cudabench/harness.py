"""One run of one cell: set-up, the measured window, the traced readings,
and the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment's sizes (the entry's ``file``);
- ``traffic/<traffic>.json``: the mix's parameters, with ``kind``, the
  module of ``kinds/`` that runs that kind of work (enrolment, 1:N
  identification, all-pairs scoring) from them;
- ``layer_metrics/<metric>.py``: ``read(trace)``, one per-layer metric, or
  None when the run has nothing for it to read;
- ``limits/<cell>.json``: the limit of each number the comparison gives.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .tracing import Profile, Spans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "multimodal_biometric_fingerprints_palms_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


@dataclass
class Trace:
    """What a traced run hands the per-layer readers."""
    spans: Spans
    profiles: dict = field(default_factory=dict)     # name -> Profile
    counters: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text()),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()))


def kind_module(cell: Cell):
    return importlib.import_module(f"cudabench.kinds.{cell.traffic['kind']}")


def reader(metric: str):
    path = BENCH / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"cudabench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): each number beside its limit; correct when every
    number the cell's limits name is finite and at most its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, program=None) -> dict:
    """The result line of one run. ``program`` replaces the port's entry
    points (the fault tests plant broken ones); ``t0`` is the process's
    start on the host clock."""
    mod = kind_module(cell)
    drv = mod.Work(cell.config, cell.traffic, seed, device,
                     program or mod.program())
    drv.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    spans = Spans(device, sync=trace)
    e2e = drv.window(seconds, spans)
    tr = Trace(spans)
    if trace:
        drv.traced(tr)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    attempted, failed = drv.counts()
    drv.release()
    numbers = drv.compare()
    correct, checks = judge(numbers, cell.limits)
    correct &= failed == 0

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = _metric(v, m["unit"])
    else:
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: _metric(v, units[k]) for k, v in e2e.items() if k in units}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        # the profile of plain steps: busy share, breakdown
        steps: Profile = tr.profiles.get("steps", Profile())
        dev["busy_s"] = steps.busy_us() / 1e6
        dev["window_s"] = steps.window_us() / 1e6
        out["breakdown"] = {"device_ops": [list(x) for x in steps.top_ops(10)],
                            "idle_gaps": [list(x) for x in steps.idle_gaps()[:10]]}
    out["checks"] = checks
    return out
