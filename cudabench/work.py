"""The yardstick's arithmetic: published peaks of one H100 and the work a
stage or a step needs, counted from shapes and inputs, whatever kernel
implements it. A roofline share is the least time this work could take on
the card over the device time measured for it.

Copied from the port's on-card smoke script, so that a later change to the
program cannot move the yardstick: the peaks, the least-time rule, kernel
E's count (20 operations for each of the 441 offsets of a pixel) and kernel
D's (10 operations a distance between a transformed valid A minutia and a
valid B minutia, with its tensors' bytes).
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: device memory bytes/s, and the
# float32 rate outside the tensor cores (integer and logic operations are
# counted at the same rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take to move ``nbytes`` (each input
    read once, each output written once) and do ``ops`` operations."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S)


def nlm_work(n: int, h: int, w: int, search: int = 21) -> tuple[float, float]:
    """(bytes, operations) of non-local means over n (h, w) float32 images:
    image in, image out; per pixel and offset a difference, a square, 6 + 6
    template adds, a scale, an exp, a weighted sample, two accumulations."""
    px = float(n * h * w)
    return 8.0 * px, 20.0 * search * search * px


def blur3_work(n: int, h: int, w: int) -> tuple[float, float]:
    """(bytes, operations) of a separable 3x3 Gaussian over n (h, w)
    float32 images: image in, image out; three multiplies and two adds a
    pass, two passes."""
    px = float(n * h * w)
    return 8.0 * px, 10.0 * px


def denoise_stage_work(n: int, h: int, w: int) -> tuple[float, float]:
    """(bytes, operations) of the denoise stage (NLM, then the 3x3 blur):
    the stage reads its input once and writes its output once; the
    intermediate image is the stage's own."""
    _, nlm_ops = nlm_work(n, h, w)
    _, blur_ops = blur3_work(n, h, w)
    return 8.0 * n * h * w, nlm_ops + blur_ops


def hypothesis_work(valid_a, valid_b, h: int) -> tuple[float, float]:
    """(bytes, operations) of scoring ``h`` hypotheses for each of P pairs,
    from the pairs' (P, K) validity masks (bool tensors or arrays): the
    matcher's tensors (x, y, orientation, type, weight, valid of each
    minutia of A and B; theta, tx, ty, has_cand a hypothesis; ``possible``)
    and both outputs; about 10 float operations a distance from a
    transformed valid A minutia to a valid B minutia (the invalid slots of
    a template share one point, so the count is what these templates need,
    not K * K)."""
    pn, kk = valid_a.shape
    na = valid_a.sum(1)
    nb = valid_b.sum(1)
    dists = float((na * nb).sum()) * h
    return float(pn * (2 * kk * 21 + 4 * (4 * h + 1 + 2 * h))), 10.0 * dists
