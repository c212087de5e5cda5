"""Device idle time while the host was inside the matcher's
``match.finish`` spans, % of the profiled probes' window."""

from cudabench.layer_metrics._program import idle_pct


def read(tr):
    return idle_pct(tr, "match.finish")
