"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
CPU tests only: frames of 120x96 on a canvas of 128x96, batches of 2, galleries of 12, 40
hypotheses, 16 minutia slots."""

import copy

from cudabench import harness


def tiny_cell(name: str) -> harness.Cell:
    c = copy.deepcopy(harness.load_cell(name))
    c.config["frame"] = {"height": 120, "width": 96}
    c.config["match"]["ransac_iter"] = 40
    c.config["templates"] = {"k": 16, "n_min": 12}
    kind = c.traffic["kind"]
    if kind == "enrol":
        c.config["templates"]["k"] = 64
        c.traffic.update(batch=2, distinct_batches=2, profiled_steps=1)
    elif kind == "identify":
        c.config["gallery"] = {"fingers": 6, "impressions": 2}
        c.traffic.update(chunk=4, profiled_probes=2, check_probes=3)
    else:
        c.config["gallery"] = {"fingers": 4, "impressions": 3}
        c.traffic.update(chunk=16, screen_iters=8, warmup_templates=6,
                         check_tiles=1, check_genuine=4)
    return c
