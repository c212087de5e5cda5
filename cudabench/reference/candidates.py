"""Candidate lists by the frozen plain matcher: each probe's scores against
the whole gallery (``match.cascade_scores``: with the cascade, the full
pass's score where the screen promotes the pair, else 0; without it, the
full pass's, as ``match.identify``), then its top L: by score descending,
the lower gallery row first between equal scores, id -1 where the score
is 0. And the numbers a candidate cell's limits hold."""

from __future__ import annotations

import numpy as np
import torch

from . import match
from .plain.features.minutiae import MinutiaeSet


def probe_scores(probes: MinutiaeSet, gal: MinutiaeSet, p: match.MatchParams,
                 screen_iters: int | None, lowp: bool = False) -> np.ndarray:
    """(P, N) scores of the (P, K) probes against every row of ``gal``:
    through the cascade at ``screen_iters`` hypotheses, anchors on, or
    without it where that is None."""
    n, m = gal.valid.shape[0], probes.valid.shape[0]
    both = MinutiaeSet(*(torch.cat([g, q]) for g, q in zip(gal, probes)))
    ia = np.repeat(n + np.arange(m), n)
    ib = np.tile(np.arange(n), m)
    return match.cascade_scores(both, ia, ib, p, screen_iters is not None,
                                screen_iters or 0, True, lowp).reshape(m, n)


def top_list(scores: np.ndarray, length: int) -> tuple[np.ndarray, np.ndarray]:
    """(ids (P, L) int64, scores (P, L) float64) of each row of (P, N)
    scores: a stable sort on the negated scores keeps the lower row first
    between equal ones; id -1 where the score is 0."""
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :length]
    top = np.take_along_axis(scores, order, axis=1)
    return np.where(top > 0, order, -1).astype(np.int64), top


def candidate_numbers(ids, scores, ref_scores: np.ndarray, length: int,
                      tol: float) -> dict:
    """The program's (P, L) lists against the reference's (P, N) scores.

    - ``score_gap``: the largest difference between a listed score and the
      reference's at the same place of its list;
    - ``candidate_mismatch``: listed ids that differ from the reference's
      at the same place, except where the listed row's reference score
      lies within ``tol`` of the reference's score there (two scores that
      close may come in either order; id -1 stands for a score of 0, and a
      row whose reference score is 0 is never listed), and each repeat of
      a row already listed for the same probe.
    """
    ids, scores = np.asarray(ids), np.asarray(scores, np.float64)
    ref_ids, ref_top = top_list(ref_scores, length)
    if ids.shape != ref_ids.shape or scores.shape != ref_top.shape:
        return {"score_gap": float("inf"), "candidate_mismatch": float("inf")}
    rows = np.arange(len(ids))[:, None]
    ok_id = (ids >= 0) & (ids < ref_scores.shape[1])
    listed = np.where(ok_id, ref_scores[rows, np.where(ok_id, ids, 0)], 0.0)
    near = np.abs(listed - ref_top) <= tol
    bad = (ids != ref_ids) & ~(near & ((listed > 0) | (ids == -1)))
    repeats = sum(int((r >= 0).sum()) - len(np.unique(r[r >= 0])) for r in ids)
    return {"score_gap": float(np.abs(scores - ref_top).max()) if scores.size else 0.0,
            "candidate_mismatch": int(bad.sum()) + repeats}
