"""Device idle time while the host was inside the program's ``enhance``
spans, % of the profiled steps' window."""

from cudabench.layer_metrics._program import idle_pct


def read(tr):
    return idle_pct(tr, "enhance")
