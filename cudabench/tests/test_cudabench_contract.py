"""BENCHMARK.json against the benchmark's contract, and the benchmark's
imports: nothing under cudabench/ loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "cudabench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PORT = "multimodal_biometric_fingerprints_palms_tpu_torch"
JAX_SIDE = {"jax", "jaxlib", "flax", "multimodal_biometric_fingerprints_palms_tpu"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["cudabench"]
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in SPEC[k]]
        assert len(got) == len(set(got)), k
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("cudabench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in CELLS:
        mine = [m for m in SPEC["end_to_end"] if w in m.get("workloads", [w])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        layer = [m for m in SPEC["per_layer"] if w in m.get("workloads", [w])]
        assert layer
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", CELLS):
            assert w in moved.get("workloads", CELLS), (m["name"], w)


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    from cudabench import harness
    c = harness.load_cell(cell)
    assert (BENCH / "kinds" / f"{c.traffic['kind']}.py").is_file()
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))


def test_layer_names_are_consistent():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"parallel.gallery", "matching", "preprocessing.enhance",
                      "features", "kernels", "device"}


def test_file_names_use_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def _imports(path: Path) -> set:
    """Top-level names of every module the file imports, and of every
    string an ``import_module`` call names."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_side_import(path):
    assert not (_imports(path) & JAX_SIDE)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PORT not in _imports(path), path
        assert PORT not in path.read_text(), path
