"""Batched 1:N search to a candidate list on one device, closed loop, one
client: each call sends the next ``probes_per_call`` probes of an order
drawn from the seed through ``parallel.gallery.identify_batch``, with the
cascade at the mix's ``screen_iters`` where the mix has ``cascade``, on a
mesh of one device, then ``parallel.gallery.candidate_list`` of
``candidates`` = L, and the (P, L) ids and scores return to the host.

The configuration's ``gallery`` gives the fingers and the impressions of
each that are enrolled (``enrolled``, else every one of ``impressions``);
the gallery is padded with ``pad_gallery`` to a multiple of ``chunk``. The
probes are ``probe_impressions`` new impressions of every finger, drawn
from the seed with the enrolled ones, so every probe is mated and none
repeats before the order wraps. Set-up draws the templates, places the
gallery and makes two calls. ``identify_p95_ms`` is the 95th percentile
over every probe of the window, a probe's latency its call's, from the
call to the lists on the host; ``identify_probes_per_s`` is the probes
completed over the whole window.

The comparison takes ``check_probes`` distinct probes of the window, drawn
from the seed, each with its last call's list, recomputes each one's
whole list with the frozen reference against the whole (unpadded) gallery,
and gives ``score_gap`` and ``candidate_mismatch``
(``reference.candidates.candidate_numbers``); for the record, not held by
a limit, the share of the window's probes whose mate heads their list
(``mate_rank1_pct``) and is in it (``mate_listed_pct``)."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import gen, work
from ..tracing import Spans, profiled
from .common import free, sampler

STEP = "identify_batch"     # kinds/identify_batch's, whose readers apply here
TIE = 1e-4          # reference scores this close may be listed in either order
FULL_PAIR = "identify_batch.full_pair"  # tr.work: a promoted pair's full pass


def program():
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import gallery
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    return SimpleNamespace(MinutiaeSet=MinutiaeSet, MatchParams=MatchParams,
                           identify_batch=gallery.identify_batch,
                           candidate_list=gallery.candidate_list,
                           pad_gallery=gallery.pad_gallery,
                           create_mesh=create_mesh)


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device, prog):
        self.p, self.device, self.seed = prog, device, seed
        self.cfg, self.tr = config, traffic
        self.per_call = traffic["probes_per_call"]
        gal = config["gallery"]
        t = config["templates"]
        enrolled = gal.get("enrolled", gal["impressions"])
        per_probe = traffic["probe_impressions"]
        each = enrolled + per_probe
        g = gen.generator(seed, device)
        tm = gen.user_templates(g, gal["fingers"], each, t["k"], t["n_min"],
                                config["frame"]["height"], config["frame"]["width"])
        rows = np.arange(gal["fingers"] * each).reshape(-1, each)
        pick = lambda r: torch.as_tensor(r.ravel(), device=device)
        self.enrolled = {f: v[pick(rows[:, :enrolled])] for f, v in tm.items()}
        self.probe_rows = {f: v[pick(rows[:, enrolled:])] for f, v in tm.items()}
        self.per_finger = (enrolled, per_probe)
        n_probes = gal["fingers"] * per_probe
        self.order = torch.randperm(n_probes, generator=g, device=device).tolist()
        ms = prog.MinutiaeSet
        self.gallery = prog.pad_gallery(ms(**self.enrolled), traffic["chunk"])
        self.probes = ms(**self.probe_rows)
        self.mesh = prog.create_mesh(device=device)
        self.params = prog.MatchParams(**config["match"])
        self.calls: list = []       # (probe ids, (P, L) ids, (P, L) scores)
        self.seconds: list = []
        self.mates: dict = {}

    def _rows(self, j: int) -> list:
        """The probe ids of the window's call ``j``: the next ``per_call``
        of the order, wrapping at its end."""
        return [self.order[(j * self.per_call + t) % len(self.order)]
                for t in range(self.per_call)]

    def _call(self, rows: list):
        t = self.tr
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        probes = self.p.MinutiaeSet(*(x.index_select(0, idx) for x in self.probes))
        cascade = ({"cascade": True, "screen_iters": t["screen_iters"]}
                   if t["cascade"] else {})
        scores = self.p.identify_batch(probes, self.gallery, self.mesh,
                                       self.params, chunk=t["chunk"], **cascade)
        ids, top = self.p.candidate_list(scores, t["candidates"])
        return ids.cpu(), top.cpu()

    def warm_up(self) -> None:
        for j in (-2, -1):
            self._call(self._rows(j))

    def window(self, seconds: float, spans: Spans) -> dict:
        t0 = time.perf_counter()
        j = j0 = len(self.calls)
        while True:
            rows = self._rows(j)
            t1 = time.perf_counter()
            with spans(STEP):
                ids, scores = self._call(rows)
            t2 = time.perf_counter()
            self.seconds.append(t2 - t1)
            self.calls.append((rows, ids.numpy(), scores.numpy()))
            j += 1
            if t2 - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        lat = np.repeat(np.asarray(self.seconds[j0:]), self.per_call)
        return {"identify_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "identify_probes_per_s": len(lat) / elapsed}

    def traced(self, tr) -> None:
        marks = Spans(self.device, sync=False)
        calls = [self._rows(len(self.calls) + j)
                 for j in range(self.tr["profiled_calls"])]
        with profiled(self.device, (STEP,)) as prof:
            for rows in calls:
                with marks(STEP):
                    self._call(rows)
        tr.profiles["steps"] = prof
        # the least time of each call's hypothesis scoring: without the
        # cascade the full pass over every pair, as ``kinds/identify_batch``
        # gives it; with it the screen over every probe x row pair, and
        # apart the full pass of one promoted pair, whose count the
        # program's counter gives the reader
        h = self.params.ransac_iter
        gv = self.gallery.valid
        screen = min(h, self.tr["screen_iters"]) if self.tr["cascade"] else h

        def least(rows, hyps):
            pv = self.probes.valid[torch.as_tensor(rows, device=self.device)]
            va = pv[:, None].expand(-1, gv.shape[0], -1).reshape(-1, pv.shape[1])
            vb = gv[None].expand(len(rows), -1, -1).reshape(-1, gv.shape[1])
            return work.least_seconds(*work.hypothesis_work(va, vb, hyps))

        tr.work[STEP] = [least(rows, screen) for rows in calls]
        if screen < h:
            # a probe and a row of the generator's n_min valid minutiae each
            one = self.probes.valid[:1]
            tr.work[FULL_PAIR] = work.least_seconds(
                *work.hypothesis_work(one, one, h))

    def counts(self) -> tuple[int, int]:
        return len(self.seconds) * self.per_call, 0

    def release(self) -> None:
        last = {}                   # probe id -> (call, row) of its last list
        for c, (rows, _, _) in enumerate(self.calls):
            for r, i in enumerate(rows):
                last[i] = (c, r)
        ids = sorted(last)
        rng = sampler(self.seed, 2)
        pick = rng.choice(len(ids), size=min(self.tr["check_probes"], len(ids)),
                          replace=False)
        self.checked = []
        for k in sorted(pick):
            c, r = last[ids[k]]
            self.checked.append((ids[k], self.calls[c][1][r], self.calls[c][2][r]))
        # for the record: how often a probe's mate (one of its finger's
        # enrolled rows) heads its list, and is in it, over the window
        enrolled, per_probe = self.per_finger
        if self.calls:
            fingers = np.concatenate([np.asarray(rows) // per_probe
                                      for rows, _, _ in self.calls])
            lists = np.concatenate([x for _, x, _ in self.calls])
            mate = (lists >= 0) & (lists // enrolled == fingers[:, None])
            self.mates = {"mate_rank1_pct": 100.0 * float(mate[:, 0].mean()),
                          "mate_listed_pct": 100.0 * float(mate.any(1).mean())}
        self.calls = []
        self.gallery = self.probes = None
        free(self.device)

    def compare(self, control: str | None = None) -> dict:
        """``score_gap`` and ``candidate_mismatch`` of the checked probes'
        lists; with ``control="bf16"`` the reference's lists in bfloat16
        stand in the program's place."""
        from ..reference import candidates as cand, match
        t = self.tr
        gal = match.as_set(self.enrolled, device=self.device)
        probes = match.as_set(self.probe_rows, rows=[i for i, _, _ in self.checked],
                              device=self.device)
        params = match.MatchParams(**self.cfg["match"])
        screen = t["screen_iters"] if t["cascade"] else None
        run = lambda lowp: cand.probe_scores(probes, gal, params, screen, lowp)
        ref = run(False)
        if control == "bf16":
            ids, scores = cand.top_list(run(True), t["candidates"])
        else:
            ids = np.stack([x for _, x, _ in self.checked])
            scores = np.stack([s for _, _, s in self.checked])
        return {**cand.candidate_numbers(ids, scores, ref, t["candidates"], TIE),
                **self.mates}
