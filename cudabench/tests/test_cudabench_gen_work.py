"""The frozen yardstick: the work counts and peaks of ``work.py`` and the
seeded generators of ``gen/``, held to numbers stored in the benchmark."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cudabench import gen, work

DIGESTS = json.loads((Path(gen.__file__).parent / "digests.json").read_text())


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def test_denoise_count_reproduces_kernel_e_bound():
    """Kernel E's bound at the main path's shape, (128, 320, 256): 1.3804
    ms, by operations."""
    nbytes, ops = work.nlm_work(128, 320, 256)
    assert work.least_seconds(nbytes, ops) * 1e3 == pytest.approx(1.3804, abs=5e-5)
    assert ops / work.PEAK_OPS_S > nbytes / work.PEAK_BYTES_S
    sb, so = work.denoise_stage_work(128, 320, 256)
    assert sb == nbytes and so == ops + 10.0 * 128 * 320 * 256


def test_hypothesis_count_by_hand():
    """One pair, K=4 slots, 3 valid A and 2 valid B minutiae, H=5: 3 x 2
    distances a hypothesis at 10 operations; bytes 2 x 4 x 21 per pair for
    the minutiae and 4 x (4 x 5 + 1 + 2 x 5) for hypotheses and outputs."""
    va = np.array([[True, True, True, False]])
    vb = np.array([[True, False, True, False]])
    nbytes, ops = work.hypothesis_work(va, vb, 5)
    assert ops == 10.0 * 3 * 2 * 5
    assert nbytes == 2 * 4 * 21 + 4 * (4 * 5 + 1 + 2 * 5)
    # tensors count alike
    assert work.hypothesis_work(torch.from_numpy(va), torch.from_numpy(vb), 5)[1] == ops


def test_generators_match_their_stored_digests():
    g = gen.generator(12345, "cpu")
    frames = gen.ridge_frames(g, 3, 64, 48)
    assert frames.dtype == torch.uint8 and frames.shape == (3, 64, 48)
    assert _digest(frames) == DIGESTS["ridge_frames(seed 12345, 3, 64, 48)"]
    g = gen.generator(12345, "cpu")
    tm = gen.user_templates(g, 3, 2, 16, 12, 128, 96)
    want = DIGESTS["user_templates(seed 12345, 3, 2, 16, 12, 128, 96)"]
    assert {k: _digest(v) for k, v in tm.items()} == want


def test_generators_follow_the_seed_and_the_frame():
    a = gen.ridge_frames(gen.generator(2 ** 31 + 5, "cpu"), 2, 64, 64)
    b = gen.ridge_frames(gen.generator(2 ** 31 + 5, "cpu"), 2, 64, 64)
    c = gen.ridge_frames(gen.generator(2 ** 31 + 6, "cpu"), 2, 64, 64)
    assert torch.equal(a, b) and not torch.equal(a, c)
    tm = gen.user_templates(gen.generator(7, "cpu"), 5, 4, 64, 40, 512, 512)
    xy = tm["xy"][tm["valid"]]
    assert tm["valid"].sum() == 5 * 4 * 40
    assert 30 < float(xy.min()) and float(xy.max()) < 482 and float(xy.max()) > 400
    # samples of one user are 1-px jitters of one constellation
    d = (tm["xy"][0, :40] - tm["xy"][1, :40]).abs().max()
    assert 0 < float(d) < 8


def test_frames_are_zero_padded_to_the_runners_canvas():
    """A 240x320 PolyU frame reaches the card as 256x320, the print at the
    top left and zeros below it, as the preprocessing runner pads it."""
    assert gen.canvas_shape(240, 320) == (256, 320)
    assert gen.canvas_shape(512, 512) == (512, 512)
    f = gen.ridge_frames(gen.generator(3, "cpu"), 2, 40, 64)
    c = gen.on_canvas(f)
    assert c.shape == (2, 64, 64) and c.dtype == torch.uint8
    assert torch.equal(c[:, :40], f) and not c[:, 40:].any()


def test_profile_arithmetic():
    """Busy time is the union of device intervals cut to the window; an
    operation belongs to the span that holds its middle, so one that reads
    as starting a little before its span still counts there."""
    from cudabench.tracing import Profile, device_time_us
    p = Profile(device_ops=[("a", 0, 10), ("b", 5, 20), ("c", 30, 40),
                            ("d", 95, 120)],
                annotations=[("x", 2, 25), ("y", 28, 90),
                             ("profiled_window", 0, 100)],
                window=(0, 100))
    assert p.busy_us() == 35
    assert device_time_us(p, "x") == [25] and device_time_us(p, "y") == [10]
    assert p.idle_gaps() == [("y", 55e-6), ("x", 10e-6)]
    assert p.top_ops() == [("b", 15e-6), ("a", 10e-6), ("c", 10e-6)]
