"""Median over the profiled steps of the device stream's milliseconds
inside the program's ``features.extract`` and ``features.postprocess``
spans, summed a step, from their CUDA events."""

from cudabench.layer_metrics._program import stream_ms_per_step


def read(tr):
    return stream_ms_per_step(tr, "enrol_step", "features.extract",
                              "features.postprocess")
