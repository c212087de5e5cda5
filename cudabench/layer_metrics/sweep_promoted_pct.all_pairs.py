"""Unique pairs the profiled sweep's screen promoted (the program's
``gallery.promoted_pairs``, counted inside the sweep), % of the sweep's
unique pairs."""

from cudabench.layer_metrics._program import counted


def read(tr):
    got = counted(tr, "gallery.promoted_pairs")
    n = tr.counters.get("unique_pairs")
    return None if got is None or not n else 100.0 * got / n
