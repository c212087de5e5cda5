"""Batched 1:N identification against a gallery sharded over the ranks of
a group that stays up, closed loop, one client: each call sends the next
``probes_per_call`` probes of an order drawn from the seed through
``parallel.gallery.ShardedGallery`` (started over ``ranks`` ranks, one a
card) and its (P, N) scores return to the host.

The configuration's ``gallery`` gives the fingers and impressions: the
first impression of every finger is enrolled, the second is its probe, so
each probe's mate is in the gallery. Set-up counts the followers' start,
the gallery's load onto the ranks and two calls. ``identify_p95_ms`` is the
95th percentile over every probe of the window, a probe's latency its
call's, from the call to the scores on the host; ``identify_probes_per_s``
is the probes completed over the whole window.

The comparison takes ``check_probes`` distinct probes of the window, drawn
from the seed, each with the scores of its last call, at the mate's column
and ``check_rows_per_shard`` columns drawn from the seed from each rank's
rows (a wrong rank order or a lost shard then shows), and compares them
with the frozen reference's scores of the same pairs."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import gen, work
from ..reference import compare as cmp
from ..tracing import Spans, profiled
from .common import free, sampler

STEP = "identify_batch"


def program():
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.gallery import (
        ShardedGallery, pad_gallery)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.launch import (
        start_ranks)
    return SimpleNamespace(MinutiaeSet=MinutiaeSet, MatchParams=MatchParams,
                           ShardedGallery=ShardedGallery, pad_gallery=pad_gallery,
                           start_ranks=start_ranks)


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device, prog):
        self.p, self.device, self.seed = prog, device, seed
        self.cfg, self.traffic = config, traffic
        self.per_call = traffic["probes_per_call"]
        self.ranks = traffic["ranks"]
        self.chunk = traffic["chunk"]
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
        self.gallery = prog.pad_gallery(ms(**self.enrolled), self.ranks * self.chunk)
        self.probes = ms(**self.probe_rows)
        self.params = prog.MatchParams(**config["match"])
        self.group = self.svc = None
        self.calls: list = []       # (probe ids, (P, N) scores) of the window
        self.seconds: list = []

    def _rows(self, j: int) -> list:
        """The probe ids of the window's call ``j``: the next ``per_call``
        of the order, wrapping at its end."""
        return [self.order[(j * self.per_call + t) % self.n]
                for t in range(self.per_call)]

    def _call(self, rows: list) -> torch.Tensor:
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        probes = self.p.MinutiaeSet(*(x.index_select(0, idx) for x in self.probes))
        return self.svc.identify_batch(probes).cpu()

    def warm_up(self) -> None:
        self.group = self.p.start_ranks(self.ranks, device=self.device.type,
                                        timeout=self.traffic["timeout_s"])
        try:
            self.svc = self.p.ShardedGallery(self.group, self.params, self.chunk)
            self.svc.load(self.gallery)
            for j in (-2, -1):
                self._call(self._rows(j))
        except BaseException:
            self.group.close()
            raise

    def window(self, seconds: float, spans: Spans) -> dict:
        try:
            t0 = time.perf_counter()
            j = j0 = len(self.calls)
            while True:
                rows = self._rows(j)
                t1 = time.perf_counter()
                with spans(STEP):
                    s = self._call(rows)
                t2 = time.perf_counter()
                self.seconds.append(t2 - t1)
                self.calls.append((rows, s.numpy()))
                j += 1
                if t2 - t0 >= seconds:
                    break
            elapsed = time.perf_counter() - t0
        except BaseException:
            self.group.close()
            raise
        lat = np.repeat(np.asarray(self.seconds[j0:]), self.per_call)
        return {"identify_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "identify_probes_per_s": len(lat) / elapsed}

    def traced(self, tr) -> None:
        marks = Spans(self.device, sync=False)
        calls = [self._rows(len(self.calls) + j)
                 for j in range(self.traffic["profiled_calls"])]
        try:
            with profiled(self.device, (STEP,)) as prof:
                for rows in calls:
                    with marks(STEP):
                        self._call(rows)
        except BaseException:
            self.group.close()
            raise
        tr.profiles["steps"] = prof
        # rank 0's share of the scoring: its rows against every probe
        n_local = self.gallery.valid.shape[0] // self.ranks
        gv = self.gallery.valid[:n_local]
        h = self.params.ransac_iter
        least = []
        for rows in calls:
            pv = self.probes.valid[torch.as_tensor(rows, device=self.device)]
            va = pv[:, None].expand(-1, n_local, -1).reshape(-1, pv.shape[1])
            vb = gv[None].expand(len(rows), -1, -1).reshape(-1, gv.shape[1])
            least.append(work.least_seconds(*work.hypothesis_work(va, vb, h)))
        tr.work[STEP] = least

    def counts(self) -> tuple[int, int]:
        return len(self.seconds) * self.per_call, 0

    def release(self) -> None:
        last = {}                   # probe id -> (call, row) of its last scoring
        for c, (rows, _) in enumerate(self.calls):
            for r, i in enumerate(rows):
                last[i] = (c, r)
        ids = sorted(last)
        rng = sampler(self.seed, 2)
        pick = rng.choice(len(ids), size=min(self.traffic["check_probes"], len(ids)),
                          replace=False)
        self.checked = [(ids[k], self.calls[last[ids[k]][0]][1][last[ids[k]][1]])
                        for k in sorted(pick)]
        n_local = self.gallery.valid.shape[0] // self.ranks
        per = self.traffic["check_rows_per_shard"]
        self.columns = []
        for i, _ in self.checked:
            cols = []
            for r in range(self.ranks):
                real = np.arange(r * n_local, min((r + 1) * n_local, self.n))
                take = rng.choice(real, size=min(per, len(real)), replace=False)
                if r * n_local <= i < (r + 1) * n_local and i not in take:
                    take[0] = i     # the mate's column is always compared
                cols.append(np.sort(take))
            self.columns.append(np.concatenate(cols))
        self.calls = []
        self.group.close()
        self.svc = self.gallery = self.probes = None
        free(self.device)

    def compare(self, control: str | None = None) -> dict:
        """The largest score gap over the checked probes' columns; with
        ``control="bf16"`` the reference in bfloat16 stands in the
        program's place."""
        from ..reference import match
        probes = match.as_set(self.probe_rows, device=self.device)
        params = match.MatchParams(**self.cfg["match"])
        prog, ref = [], []
        for (i, s), cols in zip(self.checked, self.columns):
            probe = match.MinutiaeSet(*(x[i] for x in probes))
            gal = match.as_set(self.enrolled, rows=cols, device=self.device)
            ref.append(match.identify(probe, gal, params))
            prog.append(match.identify(probe, gal, params, True)
                        if control == "bf16" else s[cols])
        return cmp.score_numbers(np.stack(prog), np.stack(ref))
