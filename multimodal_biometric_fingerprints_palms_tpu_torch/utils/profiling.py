"""Tracing and profiling helpers of the port.

- ``stage_timer``: wall-clock context manager logging a stage's time (a
  copy of the JAX package's);
- ``device_trace``: a ``torch.profiler`` trace of the host and the card,
  written as a Chrome/Perfetto trace (the JAX package traces with
  ``jax.profiler``). On the card, time work that ends in
  ``torch.cuda.synchronize()``: PyTorch returns before the device is done.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def stage_timer(name: str, n_items: int | None = None, log=logger):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if n_items:
        log.info("%s: %.3fs (%.1f items/s)", name, dt, n_items / max(dt, 1e-9))
    else:
        log.info("%s: %.3fs", name, dt)


@contextlib.contextmanager
def device_trace(trace_dir: str | Path = "logs/torch_trace"):
    """``torch.profiler`` over the block (CPU, and CUDA when available);
    the trace lands in ``trace_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
