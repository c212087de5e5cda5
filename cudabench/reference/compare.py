"""The numbers each cell's limits hold, from the program's outputs and the
reference's (numpy, on the host)."""

from __future__ import annotations

import math

import numpy as np


def enrol_numbers(prog: tuple, ref: tuple) -> dict:
    """Enhancement and features of the same frames: (mask, skeleton,
    (N, K, 7) templates, (N, K) valid) each side.

    - ``mask_mismatch_pct``: mask pixels that differ, % of all pixels;
    - ``skeleton_mismatch_pct``: skeleton pixels that differ, % of the
      reference's skeleton pixels;
    - ``minutiae_mismatch_pct``: valid minutiae on one side only (a minutia
      is its x, y and type), % of the reference's valid minutiae;
    - ``orientation_gap_rad``, ``quality_gap``: the largest difference of a
      minutia found on both sides (orientations modulo pi).

    A cell's limits name the numbers it holds; the others are read for the
    record.
    """
    mp, sp, tp, vp = (np.asarray(x) for x in prog)
    mr, sr, tr, vr = (np.asarray(x) for x in ref)
    one_side, total, d_ori, d_q = 0, 0, 0.0, 0.0
    for i in range(tp.shape[0]):
        side = [{(r[0], r[1], r[2]): r for r in t[v]} for t, v in
                ((tp[i], vp[i]), (tr[i], vr[i]))]
        common = side[0].keys() & side[1].keys()
        one_side += len(side[0]) + len(side[1]) - 2 * len(common)
        total += len(side[1])
        for key in common:
            a, b = side[0][key], side[1][key]
            d = abs((float(a[3]) - float(b[3]) + math.pi / 2) % math.pi - math.pi / 2)
            d_ori = max(d_ori, d)
            d_q = max(d_q, abs(float(a[4]) - float(b[4])))
    return {
        "mask_mismatch_pct": 100.0 * float((mp != mr).mean()),
        "skeleton_mismatch_pct": 100.0 * float((sp != sr).sum()) / max(int(sr.sum()), 1),
        "minutiae_mismatch_pct": 100.0 * one_side / max(total, 1),
        "orientation_gap_rad": d_ori,
        "quality_gap": d_q,
    }


def score_numbers(prog, ref) -> dict:
    """Scores of the same pairs: ``score_gap``, the largest absolute
    difference."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape:
        return {"score_gap": math.inf}
    return {"score_gap": float(np.abs(prog - ref).max()) if prog.size else 0.0}
