"""Median over the profiled steps of the device stream's milliseconds
inside the program's ``enhance`` span (``preprocess_fingerprint``), from
its CUDA events."""

from cudabench.layer_metrics._program import stream_ms_per_step


def read(tr):
    return stream_ms_per_step(tr, "enrol_step", "enhance")
