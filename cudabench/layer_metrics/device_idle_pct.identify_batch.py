"""Rank 0's device idle share over the profiled calls, % of their host
time."""

from cudabench.layer_metrics._shared import idle_pct


def read(tr):
    return idle_pct(tr)
