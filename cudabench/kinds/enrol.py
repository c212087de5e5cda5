"""Enrolment, closed loop, one client: each step uploads the next of
``distinct_batches`` seeded batches of ``batch`` uint8 frames from pinned
host memory (each print drawn at the configuration's frame and zero-padded
to its canvas, as the preprocessing runner pads what it reads), converts them as the preprocessing runner does, runs
``preprocess_fingerprint`` -> ``extract_minutiae`` ->
``postprocess_minutiae`` and returns the templates to the host.

``enrol_img_per_s`` is every image whose templates reached the host over
the whole window. The comparison runs the reference over one batch the
window ran, drawn from the seed, and compares the window's own masks,
skeletons and templates of that batch's last step."""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from .. import gen, work
from ..reference import compare as cmp
from ..tracing import Spans, profiled
from .common import frame, free, host_copy, no_span, sampler

STAGES = ("normalize_image", "denoise_image", "segment_fingerprint",
          "orientation", "binarize", "smooth", "thin", "extract",
          "postprocess")


def program():
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        extract_minutiae, postprocess_minutiae)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.cuda_kernels import (
        bin_to_unit)
    from multimodal_biometric_fingerprints_palms_tpu_torch.ops.orientation import (
        compute_orientation_field)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        enhance)
    return SimpleNamespace(bin_to_unit=bin_to_unit,
                           preprocess=enhance.preprocess_fingerprint,
                           extract=extract_minutiae,
                           postprocess=postprocess_minutiae,
                           enhance=enhance,
                           orientation=compute_orientation_field)


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device, prog):
        self.p, self.device, self.seed = prog, device, seed
        fh, fw, self.h, self.w = frame(config)
        self.k = config["templates"]["k"]
        self.batch = traffic["batch"]
        self.n_batches = traffic["distinct_batches"]
        self.profiled_steps = traffic["profiled_steps"]
        g = gen.generator(seed, device)
        frames = gen.on_canvas(gen.ridge_frames(g, self.batch * self.n_batches, fh, fw))
        self.frames = [host_copy(f) for f in frames.split(self.batch)]
        del frames
        self.last: dict = {}     # batch index -> the window's last outputs
        self.steps = 0

    def _step(self, i: int, span) -> tuple:
        p = self.p
        x = self.frames[i % self.n_batches].to(self.device, non_blocking=True)
        with span("enhance"):
            res = p.preprocess(p.bin_to_unit(x.to(torch.float32)))
        with span("features"):
            ms = p.postprocess(p.extract(res.skeleton, k=self.k), res.skeleton)
        return res.mask, res.skeleton, ms.as_matrix().cpu(), ms.valid.cpu()

    def warm_up(self) -> None:
        for i in range(2):
            self._step(i, no_span)

    def window(self, seconds: float, spans: Spans) -> dict:
        t0 = time.perf_counter()
        i = 0
        while True:
            self.last[i % self.n_batches] = self._step(i, spans)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.steps = i
        return {"enrol_img_per_s": i * self.batch / elapsed}

    def traced(self, tr) -> None:
        marks = Spans(self.device, sync=False)
        with profiled(self.device, ("enrol_step", "enhance", "features")) as prof:
            for i in range(self.profiled_steps):
                with marks("enrol_step"):
                    self._step(i, marks)
        tr.profiles["steps"] = prof
        # the stages alone, in preprocess_fingerprint's order, each in a
        # synchronised span
        stage = Spans(self.device, sync=True)
        p, e = self.p, self.p.enhance
        with profiled(self.device, STAGES) as prof:
            for i in range(self.profiled_steps):
                x = p.bin_to_unit(self.frames[i % self.n_batches]
                                  .to(self.device).to(torch.float32))
                with stage("normalize_image"):
                    n = e.normalize_image(x)
                with stage("denoise_image"):
                    d = e.denoise_image(n)
                with stage("segment_fingerprint"):
                    s, m = e.segment_fingerprint(d)
                with stage("orientation"):
                    f = p.orientation(s, mask=m, block_size=16, smooth_sigma=3.0,
                                      smooth_orientation_sigma=3.0)
                with stage("binarize"):
                    b = e.binarize(s)
                with stage("smooth"):
                    sm = e.smooth_fingerprint_skeleton(b.to(torch.float32))
                with stage("thin"):
                    sk = e.thinning_and_cleaning(sm, f.reliability)
                with stage("extract"):
                    ms = p.extract(sk, k=self.k)
                with stage("postprocess"):
                    p.postprocess(ms, sk)
        tr.profiles["stages"] = prof
        tr.work["denoise_image"] = work.least_seconds(
            *work.denoise_stage_work(self.batch, self.h, self.w))

    def counts(self) -> tuple[int, int]:
        return self.steps * self.batch, 0

    def release(self) -> None:
        rng = sampler(self.seed, 1)
        self.checked = int(rng.integers(len(self.last)))
        mask, skel, mat, valid = self.last[self.checked]
        self.prog = (mask.cpu(), skel.cpu(), mat, valid)
        self.last = {}
        free(self.device)

    def compare(self, control: str | None = None, block: int | None = None) -> dict:
        """The numbers of the checked batch; with ``control="bf16"`` the
        reference in bfloat16 stands in the program's place. The reference
        runs the batch whole, as the window does, or ``block`` frames at a
        time: on the card the cumulative sum over each frame's 256-bin
        histogram (Otsu's threshold in the segmentation) adds in another
        order at another number of rows, and one ulp can move a threshold
        by a bin."""
        from ..reference.enrol import enrol
        frames = self.frames[self.checked]
        block = block or self.batch
        ref = enrol(frames, self.k, self.device, block)
        prog = (enrol(frames, self.k, self.device, block, lowp=True)
                if control == "bf16" else self.prog)
        return cmp.enrol_numbers(prog, ref)
