"""The port's tracing (``utils/profiling.py``) on the CPU: spans record only
under a profiler, on the profiler's clock, with parents and request ids;
the layers open their spans in the order they run; the counters count
where the work happens."""

from __future__ import annotations

import tracemalloc

import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
    extract_minutiae, minutiae_from_numpy)
from multimodal_biometric_fingerprints_palms_tpu_torch.features.quality import (
    postprocess_minutiae)
from multimodal_biometric_fingerprints_palms_tpu_torch.kernels import build
from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
    MatchParams)
from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import gallery
from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
    create_mesh)
from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.enhance import (
    preprocess_fingerprint)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import profiling
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    make_batch, users_gallery)

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
PARAMS = MatchParams(ransac_iter=40)


@pytest.fixture(autouse=True)
def _clean():
    profiling.clear()
    yield
    profiling.clear()


def _record(fn):
    """Run ``fn`` under a CPU profiler; (its result, the spans, the
    profile)."""
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        out = fn()
    return out, profiling.recorded(), prof


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


def _gallery(users, per_user):
    tm = users_gallery(users, per_user, k=16, n_min=12, seed=3)
    return minutiae_from_numpy(tm)


def test_span_off_records_nothing_and_opens_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    before = profiling.counters()
    shared = profiling.span("a")
    assert profiling.span("b.c") is shared
    with profiling.span("a") as got:
        assert got is None
    tracemalloc.start()
    try:
        for _ in range(10_000):
            with profiling.span("enhance.denoise"):
                pass
        kept = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, profiling.__file__)])
    finally:
        tracemalloc.stop()
    assert sum(s.size for s in kept.statistics("filename")) == 0
    assert profiling.recorded() == []
    assert profiling.counters() == before


def test_the_allocation_watch_sees_a_recorded_span():
    """The watch of the test above finds what a span keeps when on."""
    with torch.profiler.profile(activities=CPU_ONLY):
        tracemalloc.start()
        try:
            with profiling.span("enhance.denoise"):
                pass
            kept = tracemalloc.take_snapshot().filter_traces(
                [tracemalloc.Filter(True, profiling.__file__)])
        finally:
            tracemalloc.stop()
    assert sum(s.size for s in kept.statistics("filename")) > 0


def test_nested_spans_keep_parents_requests_and_the_profilers_clock():
    def calls():
        for _ in range(2):
            with profiling.span("t.outer"):
                with profiling.span("t.inner"):
                    torch.ones(64).sum()
                with profiling.span("t.inner"):
                    torch.ones(64).cumsum(0)
    _, spans, prof = _record(calls)
    assert [s.name for s in spans] == ["t.outer", "t.inner", "t.inner"] * 2
    outer = [s for s in spans if s.name == "t.outer"]
    assert outer[0].request != outer[1].request
    for top in outer:
        kids = _children(spans, top)
        assert [k.name for k in kids] == ["t.inner", "t.inner"]
        assert all(k.request == top.request for k in kids)
        assert top.parent == -1
        assert all(top.start_ns <= k.start_ns <= k.end_ns <= top.end_ns
                   for k in kids)
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("t."):
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    for name in ("t.outer", "t.inner"):
        ours = [(s.start_ns, s.end_ns) for s in spans if s.name == name]
        theirs = sorted(events[name])
        assert len(ours) == len(theirs)
        for (a, b), (c, d) in zip(ours, theirs):
            assert abs(a - c) <= 100_000 and abs(b - d) <= 100_000
    assert all(s.events is None and s.stream_ms() is None for s in spans)


def test_identify_records_the_matchers_stages_in_order():
    gal = _gallery(4, 2)
    probe = type(gal)(*(x[1] for x in gal))
    mesh = create_mesh(device="cpu")
    scores, spans, _ = _record(lambda: gallery.identify(
        probe, gal, mesh, PARAMS, chunk=4))
    assert scores.shape == (8,)
    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["gallery.identify"]
    batches = _children(spans, top[0])
    assert [s.name for s in batches] == ["match.batch"] * 2
    for b in batches:
        assert [s.name for s in _children(spans, b)] == [
            "match.stats", "match.sample", "match.score", "match.finish"]
    assert {s.request for s in spans} == {top[0].request}


def test_match_pairs_counter_counts_the_pairs():
    gal = _gallery(3, 2)
    before = profiling.COUNTERS.get("match.pairs", 0)
    gallery.identify(type(gal)(*(x[0] for x in gal)), gal,
                     create_mesh(device="cpu"), PARAMS, chunk=3)
    assert profiling.COUNTERS["match.pairs"] - before == 6


def test_promoted_pairs_counter_equals_the_screens_mask():
    """``gallery.promoted_pairs`` after ``all_pairs_unique`` equals the
    promoted unique pairs of ``shard_blocks_screen``'s mask, counted from
    the mask as a reader outside the program would."""
    gal = _gallery(4, 3)
    n = gal.valid.shape[0]
    mesh = create_mesh(device="cpu")
    before = profiling.counters("gallery.")
    scores, spans, _ = _record(lambda: gallery.all_pairs_unique(
        gal, mesh, PARAMS, chunk=16, screen_iters=8))
    after = profiling.counters("gallery.")
    moved = {k: v - before.get(k, 0) for k, v in after.items()}

    screen = PARAMS._replace(ransac_iter=8, full_iters=PARAMS.ransac_iter,
                             min_inliers=max(3, PARAMS.min_inliers - 2))
    bp, mask = gallery.shard_blocks_screen(gal, mesh, screen, block=64)
    il, jl = np.divmod(np.arange(64 * 64), 64)
    gi = bp[:, :1] * 64 + il[None, :]
    gj = bp[:, 1:] * 64 + jl[None, :]
    promoted = int((mask & (gi < gj) & (gj < n)).sum())
    assert promoted > 0 and (scores > 0).sum() <= promoted
    assert moved["gallery.promoted_pairs"] == promoted
    assert moved["gallery.full_pairs"] == promoted
    assert moved["gallery.screen_pairs"] == len(bp) * 64 * 64

    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["gallery.all_pairs"]
    assert [s.name for s in _children(spans, top[0])] == [
        "gallery.screen", "gallery.promote_index", "gallery.full_pass"]
    screen_span = _children(spans, top[0])[0]
    calls = _children(spans, screen_span)
    tiles_a_call = gallery._SCREEN_PAIRS // (64 * 64)
    assert [s.name for s in calls] == ["gallery.screen_call"] * -(
        -len(bp) // tiles_a_call)
    assert sum(s.counts.get("gallery.screen_pairs", 0) for s in calls) == (
        len(bp) * 64 * 64)
    index = _children(spans, top[0])[1]
    assert index.counts == {"gallery.promoted_pairs": promoted}
    for call in calls:
        assert [s.name for s in _children(spans, call)] == [
            "match.batch", "match.anchor"]


def test_cascade_search_records_its_screen_full_pass_and_list():
    """``identify_batch`` with the cascade: ``gallery.identify_screen``
    (with the screened and promoted pairs' counts) then
    ``gallery.identify_full`` under ``gallery.identify``; the list's
    ``gallery.candidates`` beside it."""
    gal = _gallery(4, 3)
    n = gal.valid.shape[0]
    probes = gallery.take_templates(gal, [0, 4, 8])     # each its own mate
    mesh = create_mesh(device="cpu")

    def search():
        scores = gallery.identify_batch(probes, gal, mesh, PARAMS, chunk=n,
                                        cascade=True, screen_iters=8)
        return gallery.candidate_list(scores, 5), scores

    ((ids, _), scores), spans, _ = _record(search)
    promoted = int((scores > 0).sum())
    assert promoted >= 3 and (ids[:, 0] == torch.tensor([0, 4, 8])).all()
    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["gallery.identify", "gallery.candidates"]
    screen, full = _children(spans, top[0])
    assert (screen.name, full.name) == ("gallery.identify_screen",
                                        "gallery.identify_full")
    assert screen.counts["gallery.screen_pairs"] == 3 * n
    assert screen.counts["gallery.promoted_pairs"] >= promoted
    assert {s.name for s in _children(spans, full)} == {"match.batch"}


def test_enrolment_records_each_stage_under_its_layer():
    x = torch.from_numpy(make_batch(1, 64, 64))

    def enrol():
        res = preprocess_fingerprint(x)
        return postprocess_minutiae(extract_minutiae(res.skeleton, k=16),
                                    res.skeleton)
    _, spans, _ = _record(enrol)
    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["enhance", "features.extract",
                                     "features.postprocess"]
    assert [s.name for s in _children(spans, top[0])] == [
        "enhance.normalize", "enhance.denoise", "enhance.segment",
        "enhance.orientation", "enhance.binarize", "enhance.smooth",
        "enhance.thin"]
    assert [s.name for s in _children(spans, top[2])] == [
        "features.enrich", "features.nms", "features.redundant",
        "features.sort_cap"]
    assert len({s.request for s in top}) == 3


def test_the_record_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)

    def five():
        for _ in range(5):
            with profiling.span("t.step"):
                pass
    _, spans, _ = _record(five)
    assert len(spans) == 3
    assert profiling.COUNTERS[profiling.DROPPED] == 2
    assert len(profiling.recorded()) == 3          # reading keeps it
    profiling.clear()
    assert profiling.recorded() == []
    assert profiling.COUNTERS[profiling.DROPPED] == 0


def test_kernel_launches_live_in_the_one_registry():
    assert set(build.launches()) == set(build.KERNELS)
    saved = profiling.counters("kernel.")
    try:
        profiling.count("kernel.match", 5)
        assert build.launches()["match"] == saved["kernel.match"] + 5
        build.reset_launches()
        assert profiling.counters("kernel.") == dict.fromkeys(saved, 0)
    finally:
        profiling.COUNTERS.update(saved)


def test_device_trace_takes_its_path_from_the_caller():
    import inspect
    param = inspect.signature(profiling.device_trace).parameters["trace_dir"]
    assert param.default is inspect.Parameter.empty
