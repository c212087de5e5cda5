"""A rank group that stays up (``parallel.launch.start_ranks``) and the
gallery it keeps (``parallel.gallery.ShardedGallery``), over 2 and 4 gloo
ranks on the CPU.

Rank 0 is this process; the followers are spawned once a group and run
each call it hands them. Scores are held exactly: a pair's score depends
on the pair alone, not on the call or the rank that scores it, so the
sharded service equals ``identify_batch`` on one device and the frozen
plain reference of the benchmark (``cudabench/reference/match.py``) on the
whole gallery, bit for bit. Templates are K=16 with 16 minutiae, RANSAC 16,
as in ``tests/test_torch_distributed_gallery.py``.
"""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cudabench.reference import match as ref
from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
    minutiae_from_numpy)
from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
    MatchParams)
from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
    gallery as tg, launch, mesh as tmesh)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import profiling
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    users_gallery)
import torch_dist_workers as W

torch.set_num_threads(1)

PARAMS = MatchParams(**W.PARAMS)
CHUNK = 5                   # 40 rows: 20 a rank on 2 ranks, 10 on 4
TIMEOUT_S = 20.0
# one device, built by hand: inside a group ``create_mesh`` is the group's
ONE = tmesh.Mesh((torch.device("cpu"),), "gallery")
SPANS = ["ranks.dispatch", "gallery.broadcast", "gallery.local", "gallery.gather"]


def _gallery():
    return minutiae_from_numpy(users_gallery(10, 4, k=16, n_min=16, seed=5))


def _probes(g):
    return tg.take_templates(g, [1, 6, 13, 22, 39])


@pytest.fixture
def group(request):
    """A group of ``request.param`` gloo ranks (2 unless parametrised),
    closed after the test whatever its state."""
    grp = launch.start_ranks(getattr(request, "param", 2), device="cpu",
                             timeout=TIMEOUT_S)
    yield grp
    grp.close()
    assert not dist.is_initialized()


def _service(grp, g):
    svc = tg.ShardedGallery(grp, PARAMS, chunk=CHUNK)
    svc.load(g)
    return svc


def _alive(pids) -> list:
    out = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            out.append(pid)
        except ProcessLookupError:
            pass
    return out


@pytest.mark.parametrize("group", [2, 4], indirect=True)
def test_sharded_scores_equal_one_device_and_the_reference(group):
    g = _gallery()
    probes = _probes(g)
    got = _service(group, g).identify_batch(probes)
    one = tg.identify_batch(probes, g, ONE, PARAMS, chunk=CHUNK)
    assert got.shape == (5, 40) and float(got.max()) > 0
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    rp = ref.MatchParams(**W.PARAMS)
    rg = ref.as_set(g._asdict(), device="cpu")
    want = np.stack([ref.identify(ref.MinutiaeSet(*(x[i] for x in probes)), rg, rp)
                     for i in range(5)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_second_call_reuses_the_resident_shards(group):
    g = _gallery()
    svc = _service(group, g)
    shard = group.ctx.state["gallery.shard"][0]
    profiling.reset("ranks.")
    profiling.reset("gallery.gathered_bytes")
    first = svc.identify_batch(_probes(g))
    second = svc.identify_batch(_probes(g))
    assert profiling.counters("ranks.") == {"ranks.calls": 2}
    assert profiling.counters("gallery.gathered_bytes") == {
        "gallery.gathered_bytes": 2 * 5 * 40 * 4}
    assert group.ctx.state["gallery.shard"][0] is shard
    assert shard.valid.shape[0] == 20
    np.testing.assert_array_equal(first.numpy(), second.numpy())


def test_spans_on_rank_zero_in_order_and_none_without_a_profiler(group):
    g = _gallery()
    svc = _service(group, g)
    profiling.clear()
    svc.identify_batch(_probes(g))
    assert profiling.recorded() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        svc.identify_batch(_probes(g))
    names = [s.name for s in profiling.recorded() if s.name in SPANS]
    assert names == SPANS
    gather = next(s for s in profiling.recorded() if s.name == "gallery.gather")
    assert gather.counts == {"gallery.gathered_bytes": 5 * 40 * 4}
    profiling.clear()


def test_a_group_of_one_is_plain_identify_batch():
    g = _gallery()
    with launch.start_ranks(1, device="cpu") as grp:
        assert grp.pids == [] and not dist.is_initialized()
        svc = tg.ShardedGallery(grp, PARAMS, chunk=CHUNK)
        with pytest.raises(ValueError, match="before load"):
            svc.identify_batch(_probes(g))
        for bad in (tg.take_templates(g, []), tg.take_templates(g, range(37))):
            with pytest.raises(ValueError, match="whole chunks of 5"):
                svc.load(bad)
        profiling.reset("ranks.")
        got = _service(grp, g).identify_batch(_probes(g))
        assert profiling.counters("ranks.") in ({}, {"ranks.calls": 0})
    one = tg.identify_batch(_probes(g), g, ONE, PARAMS, chunk=CHUNK)
    np.testing.assert_array_equal(got.numpy(), one.numpy())


def test_a_killed_follower_fails_the_next_call_and_close_returns(group):
    g = _gallery()
    svc = _service(group, g)
    pids = group.pids
    os.kill(pids[0], signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="rank 1 of 2"):
        while time.monotonic() - t0 < TIMEOUT_S:    # until its death is seen
            svc.identify_batch(_probes(g))
    assert time.monotonic() - t0 < TIMEOUT_S
    with pytest.raises(launch.RankError, match="closed"):
        svc.identify_batch(_probes(g))
    t1 = time.monotonic()
    group.close()
    assert time.monotonic() - t1 < TIMEOUT_S
    assert _alive(pids) == []


@pytest.mark.parametrize("call, why", [
    (W.failing_call, "rank one's own failure"),
    (W.dying_call, "rank 1 of 2 exited with code 3")], ids=["raises", "dies"])
def test_a_follower_failing_inside_a_call_fails_it_in_time(group, call, why):
    pids = group.pids
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match=why):
        group.call(call)
    assert time.monotonic() - t0 < TIMEOUT_S + 5
    group.close()
    assert _alive(pids) == []
