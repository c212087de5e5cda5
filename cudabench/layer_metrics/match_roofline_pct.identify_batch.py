"""The least time of rank 0's hypothesis scoring in each profiled call
(``work.hypothesis_work`` over its P x N / W pairs: valid-slot distances x
H x 10 operations, and its tensors' bytes), % of the device time of the
whole call on rank 0."""

from cudabench.layer_metrics._shared import roofline_pct


def read(tr):
    least = tr.work.get("identify_batch")
    return None if least is None else roofline_pct(tr, "steps", "identify_batch", least)
