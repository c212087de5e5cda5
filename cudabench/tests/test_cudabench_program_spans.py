"""The readers of the program's own spans and counters
(``layer_metrics/_program.py`` and the metrics on it), on a hand-built
profile and span record: idle time put down to layers never exceeds the
device's idle share, disjoint layers add up, spans outside the profiled
steps' window are left out, and a program that records no spans gives no
reading."""

import numpy as np
import pytest
import torch

from cudabench import harness
from cudabench.harness import Trace
from cudabench.layer_metrics import _program
from cudabench.layer_metrics._shared import idle_pct as device_idle_pct
from cudabench.tracing import Profile, Spans
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import profiling
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.profiling import Span


class _Event:
    """A stand-in for a resolved CUDA timing event."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _span(name, start_us, end_us, counts=None, stream=None, parent=-1):
    events = None if stream is None else (_Event(0.0), _Event(stream))
    return Span(name, 0, parent, 0, int(start_us * 1e3), int(end_us * 1e3),
                counts or {}, events)


def _trace(ops, window, annotations=(), counters=None):
    prof = Profile(device_ops=[("k", s, e) for s, e in ops],
                   annotations=list(annotations), window=window)
    tr = Trace(Spans(torch.device("cpu"), sync=False), {"steps": prof})
    tr.counters.update(counters or {})
    return tr


@pytest.fixture
def record(monkeypatch):
    got = []
    monkeypatch.setattr(profiling, "recorded", lambda: list(got))
    return got


# the window 1000 us from 10,000; busy 100-200, 400-500, 800-900 of it:
# idle 70%
OPS = [(10_100, 10_200), (10_400, 10_500), (10_800, 10_900)]
WINDOW = (10_000.0, 11_000.0)


def test_idle_is_put_down_by_overlap(record):
    record += [_span("enhance", 10_050, 10_450),
               _span("enhance.denoise", 10_100, 10_300),
               _span("features.extract", 10_450, 10_600),
               _span("features.postprocess", 10_600, 10_950)]
    tr = _trace(OPS, WINDOW)
    assert device_idle_pct(tr) == pytest.approx(70.0)
    assert _program.idle_pct(tr, "enhance") == pytest.approx(25.0)
    assert _program.idle_pct(tr, "features") == pytest.approx(35.0)
    assert _program.idle_pct(tr, "enhance", "features") == pytest.approx(60.0)
    assert harness.reader("enhance_idle_pct.enrol")(tr) == pytest.approx(25.0)
    assert harness.reader("features_idle_pct.enrol")(tr) == pytest.approx(35.0)


def test_idle_of_any_layers_is_at_most_the_devices_and_disjoint_layers_add(
        monkeypatch):
    rng = np.random.default_rng(7)
    names = ["match.stats", "match.sample", "match.score", "match.finish"]
    for _ in range(200):
        lo = 1e6
        cuts = np.sort(rng.uniform(lo, lo + 5000, 12))
        ops = [(a, a + (b - a) * rng.uniform(0.1, 1.0))
               for a, b in zip(cuts[0::2], cuts[1::2])]
        edges = np.sort(rng.uniform(lo - 100, lo + 5100, 9))
        spans = [_span(names[i % 4], a, b)
                 for i, (a, b) in enumerate(zip(edges[:-1], edges[1:]))
                 if a >= lo and b <= lo + 5000]
        monkeypatch.setattr(profiling, "recorded", lambda: spans)
        tr = _trace(ops, (lo, lo + 5000))
        idle = device_idle_pct(tr)
        parts = [_program.idle_pct(tr, n) or 0.0 for n in names]
        whole = _program.idle_pct(tr, *names) or 0.0
        assert all(p <= idle + 1e-9 for p in parts)
        assert whole <= idle + 1e-9
        assert whole == pytest.approx(sum(parts), abs=1e-9)


def test_spans_outside_the_steps_window_are_left_out(record):
    record += [_span("match.finish", 9_000, 9_900),          # before it
               _span("match.finish", 10_500, 10_800),
               _span("match.finish", 10_900, 11_100),        # across its end
               _span("gallery.screen", 12_000, 13_000, {"gallery.promoted_pairs": 9})]
    tr = _trace(OPS, WINDOW, counters={"unique_pairs": 100})
    assert [s.start_ns for s in _program.spans(tr)] == [10_500_000]
    assert harness.reader("finish_idle_pct.identify")(tr) == pytest.approx(30.0)
    assert harness.reader("sweep_promoted_pct.all_pairs")(tr) is None
    assert harness.reader("sweep_screen_ms.all_pairs")(tr) is None


READERS = ["enhance_stream_ms.enrol", "features_stream_ms.enrol",
           "enhance_idle_pct.enrol", "features_idle_pct.enrol",
           "sample_idle_pct.identify", "finish_idle_pct.identify",
           "sweep_screen_ms.all_pairs", "sweep_promoted_pct.all_pairs",
           "screen_idle_pct.all_pairs"]


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_gives_nothing_without_spans(metric, record):
    tr = _trace(OPS, WINDOW, [("enrol_step", *WINDOW)], {"unique_pairs": 100})
    assert harness.reader(metric)(tr) is None


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_gives_nothing_on_a_program_without_the_tracer(metric, monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    tr = _trace(OPS, WINDOW, [("enrol_step", *WINDOW)], {"unique_pairs": 100})
    assert harness.reader(metric)(tr) is None


def test_stream_screen_and_promoted_readings(record):
    steps = [("enrol_step", 10_000.0, 10_500.0), ("enrol_step", 10_500.0, 11_000.0)]
    record += [_span("enhance", 10_010, 10_200, stream=70.0),
               _span("features.extract", 10_200, 10_250, stream=2.0),
               _span("features.postprocess", 10_250, 10_490, stream=80.0),
               _span("enhance", 10_510, 10_700, stream=74.0),
               _span("features.extract", 10_700, 10_750, stream=4.0),
               _span("features.postprocess", 10_750, 10_990, stream=90.0),
               _span("gallery.screen", 10_000, 10_600),
               _span("gallery.promote_index", 10_600, 10_610,
                     {"gallery.promoted_pairs": 7})]
    tr = _trace(OPS, WINDOW, steps, {"unique_pairs": 700})
    assert harness.reader("enhance_stream_ms.enrol")(tr) == pytest.approx(72.0)
    assert harness.reader("features_stream_ms.enrol")(tr) == pytest.approx(88.0)
    assert harness.reader("sweep_screen_ms.all_pairs")(tr) == pytest.approx(0.6)
    assert harness.reader("sweep_promoted_pct.all_pairs")(tr) == pytest.approx(1.0)
    assert harness.reader("screen_idle_pct.all_pairs")(tr) == pytest.approx(40.0)


def test_no_device_operation_gives_no_idle(record):
    record += [_span("enhance", 10_050, 10_450)]
    assert harness.reader("enhance_idle_pct.enrol")(_trace([], WINDOW)) is None
