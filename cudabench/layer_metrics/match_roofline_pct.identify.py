"""The least time of each probe's hypothesis scoring (``work.hypothesis_work``:
valid-slot distances x H x 10 operations, and its tensors' bytes), % of the
device time of the whole ``identify`` call, over the profiled probes."""

from cudabench.layer_metrics._shared import roofline_pct


def read(tr):
    least = tr.work.get("identify")
    return None if least is None else roofline_pct(tr, "steps", "identify", least)
