"""Matching by the frozen plain matcher: 1:N identification scores, and
the all-pairs cascade's score of a pair (the blocked screen's promotion,
then the full pass, else 0)."""

from __future__ import annotations

import numpy as np
import torch

from .plain.features.minutiae import MinutiaeSet
from .plain.matching.cuda_match import match_pairs_batch, screen_promote_batch
from .plain.matching.ransac import MatchParams

CHUNK = 512       # pairs a call of the plain matcher


def as_set(t: dict, rows=None, device=None) -> MinutiaeSet:
    """A MinutiaeSet of the template dict's ``rows`` (all if None) on
    ``device``."""
    sel = (lambda v: v) if rows is None else (
        lambda v: v[torch.as_tensor(rows, dtype=torch.int64, device=v.device)])
    return MinutiaeSet(**{f: sel(t[f]).to(device) for f in MinutiaeSet._fields})


def _take(ms: MinutiaeSet, idx) -> MinutiaeSet:
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=ms.valid.device)
    return MinutiaeSet(*(x.index_select(0, idx) for x in ms))


def pair_scores(gal: MinutiaeSet, ia, ib, p: MatchParams,
                lowp: bool = False) -> np.ndarray:
    """(P,) full-pass final scores of the pairs (gal[ia], gal[ib])."""
    out = [match_pairs_batch(_take(gal, ia[s:s + CHUNK]), _take(gal, ib[s:s + CHUNK]),
                             p, lowp).final_score.cpu().numpy()
           for s in range(0, len(ia), CHUNK)]
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def identify(probe: MinutiaeSet, gal: MinutiaeSet, p: MatchParams,
             lowp: bool = False) -> np.ndarray:
    """(N,) scores of one (K,) probe against every row of ``gal``."""
    n = gal.valid.shape[0]
    both = MinutiaeSet(*(torch.cat([g, q[None]]) for g, q in zip(gal, probe)))
    return pair_scores(both, np.full(n, n), np.arange(n), p, lowp)


def screen_params(p: MatchParams, screen_iters: int) -> MatchParams:
    """The cascade screen's parameters for a full pass ``p``: its
    hypotheses the first ``screen_iters`` of the full pass's, min_inliers
    relaxed by 2 (at least 3)."""
    return p._replace(ransac_iter=screen_iters, full_iters=p.ransac_iter,
                      min_inliers=max(3, p.min_inliers - 2))


def cascade_scores(gal: MinutiaeSet, ia, ib, p: MatchParams, cascade: bool,
                   screen_iters: int, anchors: bool,
                   lowp: bool = False) -> np.ndarray:
    """(P,) scores of the pairs under the two-phase cascade: the full
    pass's score where the screen promotes the pair, else 0 (without the
    cascade, or when the screen would run as many hypotheses as the full
    pass, the full pass's score)."""
    if not (cascade and p.ransac_iter > screen_iters):
        return pair_scores(gal, ia, ib, p, lowp).astype(np.float64)
    sp = screen_params(p, screen_iters)
    promoted = np.concatenate([
        screen_promote_batch(_take(gal, ia[s:s + CHUNK]), _take(gal, ib[s:s + CHUNK]),
                             sp, anchors, lowp).cpu().numpy()
        for s in range(0, len(ia), CHUNK)]) if len(ia) else np.zeros(0, bool)
    out = np.zeros(len(ia), np.float64)
    if promoted.any():
        out[promoted] = pair_scores(gal, ia[promoted], ib[promoted], p, lowp)
    return out
