"""The denoise stage's least time at the batch's shape (non-local means
and its 3x3 blur, ``work.denoise_stage_work``), % of the profiler's device
time inside the ``denoise_image`` spans of the traced stage pass."""

from cudabench.layer_metrics._shared import roofline_pct


def read(tr):
    least = tr.work.get("denoise_image")
    return None if least is None else roofline_pct(tr, "stages", "denoise_image", least)
