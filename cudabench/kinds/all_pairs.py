"""All-pairs scoring, back to back: ``parallel.gallery.all_pairs_unique``
over every unique pair of a gallery of the configuration's size (fingers x
impressions), on a mesh of one device, with the mix's cascade settings.
Set-up draws ``distinct_galleries`` galleries from the seed, and the
window's sweeps take them in turn, so no sweep of a window repeats the one
before it.

``match_pairs_per_s`` is the unique pairs of every whole sweep the window
ran over those sweeps' time; a sweep starts while the window has more than
half of the last sweep's time left. Warm-up is one sweep over the first
``warmup_templates`` templates, the same tile and chunk shapes. The
comparison takes ``check_tiles`` of the blocked screen's tiles and
``check_genuine`` genuine pairs, drawn from the seed, and compares the
window's last sweep's scores of those pairs with the reference's cascade
over that sweep's gallery: the full pass's score where the screen promotes
a pair, else 0."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from .. import gen
from ..tracing import Spans, profiled
from ..reference import compare as cmp
from .common import frame, free, sampler


def program():
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
        MinutiaeSet)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import gallery
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.mesh import (
        create_mesh)
    return SimpleNamespace(MinutiaeSet=MinutiaeSet, MatchParams=MatchParams,
                           all_pairs_unique=gallery.all_pairs_unique,
                           shard_blocks_screen=gallery.shard_blocks_screen,
                           create_mesh=create_mesh)


class Work:
    BLOCK = 64        # all_pairs_unique's tile side

    def __init__(self, config: dict, traffic: dict, seed: int, device, prog):
        self.p, self.device, self.seed, self.cfg = prog, device, seed, config
        self.tr = traffic
        gal = config["gallery"]
        t = config["templates"]
        g = gen.generator(seed, device)
        self.n = gal["fingers"] * gal["impressions"]
        self.per_user = gal["impressions"]
        d = traffic["distinct_galleries"]
        rows = gen.user_templates(
            g, gal["fingers"] * d, gal["impressions"], t["k"], t["n_min"],
            config["frame"]["height"], config["frame"]["width"])
        # gallery i: rows i * n to (i + 1) * n, fingers of their own
        self.templates = [{f: v[i * self.n:(i + 1) * self.n] for f, v in rows.items()}
                          for i in range(d)]
        self.galleries = [prog.MinutiaeSet(**tm) for tm in self.templates]
        self.mesh = prog.create_mesh(device=device)
        self.params = prog.MatchParams(**config["match"])
        self.pairs = self.n * (self.n - 1) // 2
        self.sweeps = 0
        self.last = None
        self.last_gallery = None

    def _sweep(self, gal):
        t = self.tr
        return self.p.all_pairs_unique(
            gal, self.mesh, self.params, chunk=t["chunk"], cascade=t["cascade"],
            screen_iters=t["screen_iters"], anchors=t["anchors"])

    def warm_up(self) -> None:
        m = self.tr["warmup_templates"]
        self._sweep(self.p.MinutiaeSet(*(x[:m] for x in self.galleries[0])))

    def window(self, seconds: float, spans: Spans) -> dict:
        t0 = time.perf_counter()
        last = 0.0
        while self.sweeps == 0 or time.perf_counter() - t0 + last / 2 < seconds:
            t1 = time.perf_counter()
            k = self.sweeps % len(self.galleries)
            with spans("all_pairs_unique"):
                self.last = self._sweep(self.galleries[k])
            last = time.perf_counter() - t1
            self.last_gallery = k
            self.sweeps += 1
        elapsed = time.perf_counter() - t0
        return {"match_pairs_per_s": self.sweeps * self.pairs / elapsed}

    def traced(self, tr) -> None:
        marks = Spans(self.device, sync=False)
        with profiled(self.device, ("all_pairs_unique",)) as prof:
            with marks("all_pairs_unique"):
                self._sweep(self.galleries[0])
        tr.profiles["steps"] = prof
        # the blocked screen alone over the whole gallery, as the sweep
        # calls it
        t = self.tr
        sp = self.params._replace(ransac_iter=t["screen_iters"],
                                  full_iters=self.params.ransac_iter,
                                  min_inliers=max(3, self.params.min_inliers - 2))
        with tr.spans("screen"):
            bp, mask = self.p.shard_blocks_screen(self.galleries[0], self.mesh, sp,
                                                  block=self.BLOCK,
                                                  anchors=t["anchors"])
        b = self.BLOCK
        il, jl = np.divmod(np.arange(b * b), b)
        gi = bp[:, :1] * b + il[None, :]
        gj = bp[:, 1:] * b + jl[None, :]
        tr.counters["promoted_pairs"] = int((mask & (gi < gj) & (gj < self.n)).sum())
        tr.counters["unique_pairs"] = self.pairs

    def counts(self) -> tuple[int, int]:
        return self.sweeps * self.pairs, 0

    def _checked_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """(i, j) with i < j: every unique pair of ``check_tiles`` tiles and
        ``check_genuine`` genuine pairs, drawn from the seed."""
        rng = sampler(self.seed, 3)
        b, n = self.BLOCK, self.n
        nb = -(-n // b)
        bi, bj = np.triu_indices(nb)
        ii, jj = [], []
        for t in rng.choice(len(bi), size=min(self.tr["check_tiles"], len(bi)),
                            replace=False):
            il, jl = np.divmod(np.arange(b * b), b)
            gi, gj = bi[t] * b + il, bj[t] * b + jl
            keep = (gi < gj) & (gj < n)
            ii.append(gi[keep])
            jj.append(gj[keep])
        u = self.per_user
        a, c = np.triu_indices(u, k=1)
        users = rng.integers(n // u, size=self.tr["check_genuine"])
        k = rng.integers(len(a), size=len(users))
        ii.append(users * u + a[k])
        jj.append(users * u + c[k])
        return np.concatenate(ii).astype(np.int64), np.concatenate(jj).astype(np.int64)

    def release(self) -> None:
        ii, jj = self._checked_pairs()
        n = self.n
        scores = np.asarray(self.last)
        # a result of another length than the sweep's pairs holds none of
        # them: the comparison reads it as a gap of inf
        got = (scores[ii * (2 * n - ii - 1) // 2 + (jj - ii - 1)]
               if scores.shape == (self.pairs,) else scores)
        self.checked = (ii, jj, got)
        self.last = None
        self.galleries = None
        free(self.device)

    def compare(self, control: str | None = None) -> dict:
        """The largest score gap over the checked pairs; with
        ``control="bf16"`` the reference in bfloat16 stands in the
        program's place."""
        from ..reference import match
        ii, jj, prog = self.checked
        gal = match.as_set(self.templates[self.last_gallery], device=self.device)
        params = match.MatchParams(**self.cfg["match"])
        t = self.tr
        run = lambda lowp: match.cascade_scores(gal, ii, jj, params, t["cascade"],
                                                t["screen_iters"], t["anchors"], lowp)
        ref = run(False)
        return cmp.score_numbers(run(True) if control == "bf16" else prog, ref)
