"""1:N identification, closed loop, one client: probes one at a time, in
an order drawn from the seed, through ``parallel.gallery.identify`` against
the gallery padded with ``pad_gallery`` to a multiple of ``chunk``; each
probe's scores return to the host.

The configuration's ``gallery`` gives the fingers and impressions: the
first impression of every finger is enrolled, the second is its probe, so
each probe's mate is in the gallery. ``identify_p95_ms`` is the 95th
percentile of every probe of the window, from the call to its scores on
the host; ``identify_probes_per_s`` is the probes completed over the whole
window. The comparison takes ``check_probes`` of the window's probes,
drawn from the seed, and compares the window's own scores of them with the
reference's against the whole gallery."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import gen, work
from ..reference import compare as cmp
from ..tracing import Spans, profiled
from .common import free, sampler


def program():
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import gallery
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    return SimpleNamespace(MinutiaeSet=MinutiaeSet, MatchParams=MatchParams,
                           identify=gallery.identify,
                           pad_gallery=gallery.pad_gallery,
                           create_mesh=create_mesh)


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device, prog):
        self.p, self.device, self.seed = prog, device, seed
        self.cfg = config
        self.chunk = traffic["chunk"]
        self.check = traffic["check_probes"]
        self.profiled_probes = traffic["profiled_probes"]
        gal = config["gallery"]
        t = config["templates"]
        g = gen.generator(seed, device)
        tm = gen.user_templates(g, gal["fingers"], gal["impressions"], t["k"],
                                t["n_min"], config["frame"]["height"],
                                config["frame"]["width"])
        self.enrolled = {f: v[0::gal["impressions"]] for f, v in tm.items()}
        self.probe_rows = {f: v[1::gal["impressions"]] for f, v in tm.items()}
        self.n = gal["fingers"]
        self.order = torch.randperm(self.n, generator=g, device=device).tolist()
        ms = prog.MinutiaeSet
        self.gallery = prog.pad_gallery(ms(**self.enrolled), self.chunk)
        self.probes = ms(**self.probe_rows)
        self.mesh = prog.create_mesh(device=device)
        self.params = prog.MatchParams(**config["match"])
        self.scores: list = []      # (probe, (N,) scores) of the window
        self.seconds: list = []

    def _call(self, i: int) -> torch.Tensor:
        probe = self.p.MinutiaeSet(*(x[i] for x in self.probes))
        return self.p.identify(probe, self.gallery, self.mesh, self.params,
                               chunk=self.chunk).cpu()

    def warm_up(self) -> None:
        for i in self.order[-2:]:
            self._call(i)

    def window(self, seconds: float, spans: Spans) -> dict:
        t0 = time.perf_counter()
        j = 0
        while True:
            i = self.order[j % self.n]
            t1 = time.perf_counter()
            with spans("identify"):
                s = self._call(i)
            t2 = time.perf_counter()
            self.seconds.append(t2 - t1)
            self.scores.append((i, s.numpy()))
            j += 1
            if t2 - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        lat = np.asarray(self.seconds)
        return {"identify_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "identify_probes_per_s": len(lat) / elapsed}

    def traced(self, tr) -> None:
        marks = Spans(self.device, sync=False)
        probes = self.order[:self.profiled_probes]
        with profiled(self.device, ("identify",)) as prof:
            for i in probes:
                with marks("identify"):
                    self._call(i)
        tr.profiles["steps"] = prof
        h = self.params.ransac_iter
        gv = self.gallery.valid
        tr.work["identify"] = [work.least_seconds(*work.hypothesis_work(
            self.probes.valid[i][None].expand(gv.shape[0], -1), gv, h))
            for i in probes]

    def counts(self) -> tuple[int, int]:
        return len(self.seconds), 0

    def release(self) -> None:
        rng = sampler(self.seed, 2)
        pick = rng.choice(len(self.scores), size=min(self.check, len(self.scores)),
                          replace=False)
        self.checked = [self.scores[k] for k in sorted(pick)]
        self.scores = []
        self.gallery = self.probes = None
        free(self.device)

    def compare(self, control: str | None = None) -> dict:
        """The largest score gap over the checked probes; with
        ``control="bf16"`` the reference in bfloat16 stands in the
        program's place."""
        from ..reference import match
        gal = match.as_set(self.enrolled, device=self.device)
        probes = match.as_set(self.probe_rows, device=self.device)
        params = match.MatchParams(**self.cfg["match"])
        prog, ref = [], []
        for i, s in self.checked:
            probe = match.MinutiaeSet(*(x[i] for x in probes))
            r = match.identify(probe, gal, params)
            # the padded rows are invalid templates, which score 0
            pad = np.zeros(len(s) - len(r))
            ref.append(np.concatenate([r, pad]))
            prog.append(np.concatenate([match.identify(probe, gal, params, True), pad])
                        if control == "bf16" else s)
        return cmp.score_numbers(np.stack(prog), np.stack(ref))
