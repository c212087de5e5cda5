"""Spans around the benchmark's calls into the program, and the reading of
``torch.profiler``'s trace.

A span records its host-clock interval and opens a profiler annotation of
the same name. In a traced run (``sync=True``) it synchronises the device
before it starts and before it ends, so that its interval is the device's
work of the call; in a timed run it adds no synchronisation.

``Profile`` holds what the per-layer readers need from one profiled block:
the device operations (kernels, copies, fills) and the benchmark's
annotations, each as (name, start_us, end_us) on the profiler's clock, and
the block's own interval.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field

import torch

WINDOW = "profiled_window"
NAME_CHARS = 160


class Spans:
    """Named host-clock intervals, kept in memory."""

    def __init__(self, device: torch.device, sync: bool):
        self.device = device
        self.sync = sync and device.type == "cuda"
        self.seconds: dict[str, list[float]] = {}

    def _wait(self):
        if self.sync:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(name):
            self._wait()
            t0 = time.perf_counter()
            yield
            self._wait()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def median_ms(self, name: str) -> float | None:
        got = self.seconds.get(name)
        return statistics.median(got) * 1e3 if got else None


@dataclass
class Profile:
    device_ops: list = field(default_factory=list)    # (name, start, end) us
    annotations: list = field(default_factory=list)   # (name, start, end) us
    window: tuple = (0.0, 0.0)                       # us

    def ops_within(self, start: float, end: float) -> list:
        """The device operations whose middle lies in [start, end]. The
        profiler maps the device's clock onto the host's only to within
        some microseconds, so an operation that starts just after a span
        opens can read as starting before it: its middle does not."""
        return [op for op in self.device_ops
                if start <= (op[1] + op[2]) / 2 <= end]

    def intervals(self, name: str) -> list:
        return [(s, e) for n, s, e in self.annotations if n == name]

    def _busy(self) -> list:
        """The union of the device operations' intervals, cut to the
        window."""
        lo, hi = self.window
        return [(max(s, lo), min(e, hi)) for s, e in _merged(self.device_ops)
                if e > lo and s < hi]

    def busy_us(self) -> float:
        return sum(e - s for s, e in self._busy())

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def idle_gaps(self) -> list:
        """(name, seconds) of each stretch of the window with no device
        operation, named by the innermost annotation the host was in at its
        middle ("none" outside every annotation), longest first."""
        busy = self._busy()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        inner = [a for a in self.annotations if a[0] != WINDOW]
        out = []
        for s, e in gaps:
            mid = (s + e) / 2
            holding = [a for a in inner if a[1] <= mid <= a[2]]
            name = min(holding, key=lambda a: a[2] - a[1])[0] if holding else "none"
            out.append((name, (e - s) / 1e6))
        return sorted(out, key=lambda g: -g[1])

    def top_ops(self, n: int = 10) -> list:
        """(name, seconds) of the ``n`` device operations with the most
        summed time inside the window, each name cut to ``NAME_CHARS``
        (a kernel's template arguments run to thousands of characters)."""
        tot: dict[str, float] = {}
        for name, s, e in self.ops_within(*self.window):
            name = name[:NAME_CHARS]
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def _merged(ops) -> list:
    out = []
    for _, s, e in sorted(ops, key=lambda op: op[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def _edge(device: torch.device) -> None:
    """A pause and a sentinel kernel between the profiler's edge and the
    window: a short profiled block has been seen to come back one device
    operation short at its edge. The sentinel lies outside the window."""
    if device.type == "cuda":
        torch.cuda._sleep(1)
        torch.cuda.synchronize(device)
        time.sleep(0.05)


@contextlib.contextmanager
def profiled(device: torch.device, names):
    """Profile the block (CPU and, on a card, CUDA activity); yields a
    ``Profile`` that is filled when the block ends. ``names`` are the
    spans the block opens: the profiler's events of those names are the
    annotations, and the device's events of any other name are its
    operations (the profiler mirrors an annotation on the device too)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    marks = set(names) | {WINDOW}
    out = Profile()
    with torch.profiler.profile(activities=acts) as prof:
        _edge(device)
        with torch.profiler.record_function(WINDOW):
            yield out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        _edge(device)
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns() / 1e3
        e = s + ev.duration_ns() / 1e3
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in marks:
                out.device_ops.append((name, s, e))
        elif name in marks:
            out.annotations.append((name, s, e))
    win = [(s, e) for n, s, e in out.annotations if n == WINDOW]
    out.window = win[0] if win else (0.0, 0.0)


def device_time_us(profile: Profile, name: str) -> list:
    """Summed device-operation time inside each ``name`` annotation (the
    spans of a traced run synchronise at both ends, and a call ends in a
    copy to the host, so every operation the call issued runs inside its
    interval)."""
    return [sum(e - s for _, s, e in profile.ops_within(a, b))
            for a, b in profile.intervals(name)]
