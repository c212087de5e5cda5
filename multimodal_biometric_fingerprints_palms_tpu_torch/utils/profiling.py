"""Tracing of the port: spans at its layers' boundaries, counters where the
work happens, and the operator's trace.

- ``span(name)``: a span around one call of a layer. It records only while
  a ``torch.profiler`` profile is recording; otherwise it tests one flag
  and returns a shared object that does nothing. While recording it opens
  a profiler event of its name (so the span shows in a Chrome trace) and
  keeps a ``Span`` in memory: its name, its host interval on
  ``time.time_ns()`` (the clock the profiler stamps its events on), the
  index of its parent, a request id shared by every span under one
  top-level span, the counts made inside it, and, in a process with CUDA
  initialised, a pair of timing events on the current stream, resolved
  only when read (``Span.stream_ms``). Names are dotted by layer:
  ``enhance.denoise``, ``features.nms``, ``match.sample``,
  ``gallery.screen``.
- ``traced(name)``: a decorator that runs the function inside ``span(name)``.
- ``recorded()``, ``clear()``: the record, kept until cleared and at most
  ``CAP`` spans; ``COUNTERS["trace.dropped_spans"]`` counts those past it.
- ``count(name, n)``, ``counters(prefix)``, ``reset(prefix)``: the one
  counter registry, always on: kernel launches as ``kernel.<name>``, the
  gallery's and the matcher's pairs.
- ``device_trace(trace_dir)``: ``torch.profiler`` over a block, written as
  ``trace_dir/trace.json`` (a Chrome/Perfetto trace holding the spans) and
  ``trace_dir/counters.json`` (what each counter counted in the block).

The profiler event is a FUNCTION-scope record function, not
``torch.profiler.record_function``: the profiler mirrors a
``record_function`` annotation onto the device's timeline, where a reader
of device operations would count it as one, and it costs about 9 us a
call even when nothing records.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

CAP = 1 << 16
COUNTERS: dict[str, int] = {}
DROPPED = "trace.dropped_spans"

_RECORD: list = []
_requests = itertools.count()
_local = threading.local()


@dataclass(eq=False, slots=True)
class Span:
    name: str
    index: int                    # position in the record
    parent: int                   # the parent's index, -1 at the top
    request: int
    start_ns: int = 0
    end_ns: int = 0
    counts: dict = field(default_factory=dict)
    events: tuple | None = None   # (start, end) CUDA timing events

    def stream_ms(self) -> float | None:
        """Milliseconds of the current stream between the span's ends
        (waits for the end event); None without CUDA."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _On:
    __slots__ = ("span", "_event")

    def __init__(self, name: str):
        stack = _stack()
        top = stack[-1] if stack else None
        self.span = Span(name, len(_RECORD),
                         top.index if top else -1,
                         top.request if top else next(_requests))
        self._event = _RecordFunctionFast(name)

    def __enter__(self) -> Span:
        sp = self.span
        self._event.__enter__()
        if torch.cuda.is_initialized():
            sp.events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            sp.events[0].record()
        _RECORD.append(sp)
        _stack().append(sp)
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, typ, value, tb):
        sp = self.span
        sp.end_ns = time.time_ns()
        _stack().pop()
        if sp.events is not None:
            sp.events[1].record()
        self._event.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager that records the span ``name`` while a profiler
    is recording, and otherwise does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if len(_RECORD) >= CAP:
        count(DROPPED)
        return _OFF
    return _On(name)


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def recorded() -> list:
    """The spans recorded since the last ``clear()``, in the order they
    opened (a parent before its children)."""
    return list(_RECORD)


def clear() -> None:
    _RECORD.clear()
    COUNTERS[DROPPED] = 0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to the innermost open span's
    counts while one records."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def counters(prefix: str = "") -> dict:
    """A copy of the counters whose names start with ``prefix``."""
    return {k: v for k, v in COUNTERS.items() if k.startswith(prefix)}


def reset(prefix: str = "") -> None:
    """Set the counters whose names start with ``prefix`` to 0."""
    for k in counters(prefix):
        COUNTERS[k] = 0


@contextlib.contextmanager
def device_trace(trace_dir: str | Path):
    """``torch.profiler`` over the block (the host, and CUDA when
    available), with the port's spans recording. Writes
    ``trace_dir/trace.json`` (Chrome/Perfetto) and
    ``trace_dir/counters.json``: each counter's count over the block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    before = counters()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    delta = {k: v - before.get(k, 0) for k, v in counters().items()}
    (out / "counters.json").write_text(json.dumps(delta, indent=1, sort_keys=True))
