"""Median over the profiled calls of rank 0's device stream milliseconds
inside the program's ``gallery.local`` span (its own shard's scoring,
before the gather), from the span's CUDA events."""

from cudabench.layer_metrics._program import stream_ms_per_step


def read(tr):
    return stream_ms_per_step(tr, "identify_batch", "gallery.local")
