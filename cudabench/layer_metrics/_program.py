"""What the readers of the program's own spans and counters share.

The program records its spans (``utils.profiling.span``) while a profiler
records, so the traced run's profiles hold them; a reader keeps only those
that lie inside the profiled steps' window (``tr.profiles["steps"]``), as
the enrol cell profiles a stage pass besides. A span's interval is on
``time.time_ns()``, the clock the profiler stamps its events on, so it lies
beside the profile's device operations. A program without that tracer
records nothing, and every reader then returns None.

"Idle in a layer" is the stretches of the window with no device operation
(the busy union the profile computes), intersected with the union of the
host intervals of the layer's spans: % of the window, by overlap.
"""

from __future__ import annotations

import statistics


def _recorded() -> list:
    try:
        from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (
            profiling)
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded", None)
    return recorded() if recorded else []


def spans(tr) -> list:
    """The program's spans inside the profiled steps' window."""
    prof = tr.profiles.get("steps")
    if prof is None or prof.window_us() <= 0:
        return []
    lo, hi = prof.window
    return [s for s in _recorded() if lo <= s.start_ns / 1e3 and s.end_ns / 1e3 <= hi]


def under(name: str, layers) -> bool:
    """Whether the span ``name`` is one of ``layers`` or under one."""
    return any(name == x or name.startswith(x + ".") for x in layers)


def _union(ivs) -> list:
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: list, b: list) -> float:
    """Total overlap of two sorted lists of disjoint intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_gaps(prof) -> list:
    """The window's stretches with no device operation, (start, end) us."""
    edges = [prof.window[0]] + [x for iv in prof._busy() for x in iv] + [prof.window[1]]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_pct(tr, *layers) -> float | None:
    """Idle time of the window while the host was inside a span of
    ``layers``, % of the window; None without a device operation or
    without such a span."""
    prof = tr.profiles.get("steps")
    mine = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in spans(tr)
            if under(s.name, layers)]
    if prof is None or not prof.device_ops or not mine:
        return None
    return 100.0 * _overlap(idle_gaps(prof), _union(mine)) / prof.window_us()


def stream_ms_per_step(tr, step: str, *names) -> float | None:
    """Median over the profiled steps (the benchmark's ``step``
    annotations) of the summed CUDA-event milliseconds of the spans named
    ``names`` in each; None without such events."""
    prof = tr.profiles.get("steps")
    got = [s for s in spans(tr) if s.name in names]
    if prof is None or not got or got[0].stream_ms() is None:
        return None
    per_step = [sum(s.stream_ms() for s in got
                    if a <= s.start_ns / 1e3 and s.end_ns / 1e3 <= b)
                for a, b in prof.intervals(step)]
    return statistics.median(per_step) if per_step else None


def host_ms(tr, name: str) -> float | None:
    """Median host milliseconds of the spans ``name``."""
    got = [(s.end_ns - s.start_ns) / 1e6 for s in spans(tr) if s.name == name]
    return statistics.median(got) if got else None


def counted(tr, name: str) -> int | None:
    """The count ``name`` made inside the window's spans; None where no
    span counted it."""
    got = [s.counts[name] for s in spans(tr) if name in s.counts]
    return sum(got) if got else None
