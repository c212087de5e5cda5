"""Median over the profiled calls of the device stream milliseconds inside
the program's ``gallery.identify_screen`` span (the cascade screen's calls
of a search, to the promoted pairs' indices), from the span's CUDA
events."""

from cudabench.layer_metrics._program import stream_ms_per_step


def read(tr):
    return stream_ms_per_step(tr, "identify_batch", "gallery.identify_screen")
