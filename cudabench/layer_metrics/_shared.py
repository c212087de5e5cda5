"""Arithmetic the readers share, on a traced run's ``Trace``."""

from __future__ import annotations

from cudabench.tracing import device_time_us


def idle_pct(tr) -> float | None:
    """100 x (1 - union of the device operations' intervals / host time)
    over the profiled steps; None without a device operation."""
    prof = tr.profiles.get("steps")
    if prof is None or not prof.device_ops or prof.window_us() <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_us() / prof.window_us())


def roofline_pct(tr, profile: str, span: str, least_s) -> float | None:
    """100 x the least time of the span's work over the device time inside
    the span, summed over its occurrences; ``least_s`` is one number for
    every occurrence or a list, one each. None without device time."""
    prof = tr.profiles.get(profile)
    if prof is None:
        return None
    dev = device_time_us(prof, span)
    if not dev or sum(dev) <= 0:
        return None
    least = least_s if isinstance(least_s, list) else [least_s] * len(dev)
    return 100.0 * sum(least[:len(dev)]) * 1e6 / sum(dev)
