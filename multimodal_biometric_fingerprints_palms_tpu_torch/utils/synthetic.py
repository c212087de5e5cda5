"""Synthetic fingerprint-like images, numpy only (no file, no network).

``make_batch`` is the port's copy of the root ``bench.py``'s generator, the
JAX package's benchmark input: concentric-ridge prints at PolyU size.
``blob_prints`` is a copy of ``tests/test_end_to_end_eer.py``'s ``_print``:
the same ridges with square blobs punched in, which leave >= 8 minutiae
after quality filtering (``make_batch``'s prints keep only 1-8, in the JAX
package and in the port alike). ``users_gallery`` is a copy of the matcher
benchmark's template gallery (``benchmarks/bench_matching.py``).
``tests/test_torch_synthetic.py`` holds all three equal to their originals.
"""

from __future__ import annotations

import numpy as np


def make_batch(batch: int, h: int = 320, w: int = 256) -> np.ndarray:
    """(batch, h, w) float32 ridge images in [0,1], deterministic."""
    g = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((batch, h, w), np.float32)
    for b in range(batch):
        cy, cx = h / 2 + g.uniform(-20, 20), w / 2 + g.uniform(-20, 20)
        r = np.sqrt(((yy - cy) / 1.1) ** 2 + (xx - cx) ** 2)
        ang = np.arctan2(yy - cy, xx - cx)
        ridges = 0.5 + 0.5 * np.cos(r / 4.5 + 2.0 * np.sin(3 * ang)
                                    + g.uniform(0, 6.28))
        ell = (((yy - cy) / (0.42 * h)) ** 2
               + ((xx - cx) / (0.40 * w)) ** 2) < 1
        img = np.where(ell, 1.0 - 0.8 * ridges, 0.95)
        out[b] = np.clip(img + g.normal(0, 0.02, (h, w)), 0, 1)
    return out


def blob_prints(seeds, phases=None, h: int = 320, w: int = 256) -> np.ndarray:
    """(len(seeds), h, w) float32 prints on the uint8 grid, one per seed;
    ``phases`` shifts the ridge pattern, as a second session."""
    seeds = list(seeds)
    phases = [0.0] * len(seeds) if phases is None else list(phases)
    out = np.empty((len(seeds), h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.sqrt(((yy - h / 2) / 1.1) ** 2 + (xx - w / 2) ** 2)
    ang = np.arctan2(yy - h / 2, xx - w / 2)
    ell = (((yy - h / 2) / (0.42 * h)) ** 2
           + ((xx - w / 2) / (0.40 * w)) ** 2) < 1
    for i, (seed, phase) in enumerate(zip(seeds, phases)):
        ridges = 0.5 + 0.5 * np.cos(r / 4.5 + 2.0 * np.sin(3 * ang) + phase)
        g = np.random.default_rng(seed)
        blobs = np.zeros((h, w), np.float32)
        for _ in range(110):
            by, bx = g.integers(40, h - 40), g.integers(40, w - 40)
            rr = g.integers(2, 6)
            blobs[by - rr:by + rr, bx - rr:bx + rr] = 1.0
        img = np.where(ell, 1.0 - 0.8 * ridges * (1 - 0.9 * blobs), 0.95)
        img = np.clip(img + g.normal(0, 0.02, (h, w)), 0, 1) * 255
        out[i] = img.astype(np.uint8).astype(np.float32) / 255.0
    return out


def users_gallery(n_users: int, samples_per_user: int, k: int = 64,
                  n_min: int = 40, seed: int = 0) -> dict[str, np.ndarray]:
    """PolyU-structured (n_users * samples_per_user, k) template gallery,
    the port's copy of ``benchmarks/bench_matching.synth_users_gallery``:
    each user is a random constellation of ``n_min`` minutiae and its
    samples are jittered copies (1 px), so genuine pairs really match.
    Returns numpy arrays keyed by the ``MinutiaeSet`` field names
    (``features.minutiae.minutiae_from_numpy`` makes the tensors)."""
    g = np.random.default_rng(seed)
    n = n_users * samples_per_user
    xy = np.zeros((n, k, 2), np.float32)
    ori = np.zeros((n, k), np.float32)
    ty = np.zeros((n, k), np.int32)
    q = np.zeros((n, k), np.float32)
    valid = np.zeros((n, k), bool)
    i = 0
    for _ in range(n_users):
        base_xy = g.random((n_min, 2), dtype=np.float32) * 180 + 40
        base_ori = (g.random(n_min, dtype=np.float32) - 0.5) * np.pi
        base_ty = (g.random(n_min) > 0.5).astype(np.int32)
        base_q = 0.4 + 0.6 * g.random(n_min, dtype=np.float32)
        for _ in range(samples_per_user):
            xy[i, :n_min] = base_xy + g.normal(0, 1.0, (n_min, 2))
            ori[i, :n_min] = base_ori
            ty[i, :n_min] = base_ty
            q[i, :n_min] = base_q
            valid[i, :n_min] = True
            i += 1
    return dict(xy=xy, minutia_type=ty, orientation=ori, quality=q,
                coherence=q, angular_stability=q, valid=valid)


def spiral_mask(h: int, w: int) -> np.ndarray:
    """A one-pixel-wide rectangular spiral from the top-left corner inwards,
    one pixel of background between its arms: one long component, 4- and
    8-connected alike."""
    m = np.zeros((h, w), bool)
    y = x = 0
    dy, dx = 0, 1
    m[0, 0] = True

    def free(sy, sx):
        ny, nx, fy, fx = y + sy, x + sx, y + 2 * sy, x + 2 * sx
        return (0 <= ny < h and 0 <= nx < w and not m[ny, nx]
                and not (0 <= fy < h and 0 <= fx < w and m[fy, fx]))

    while True:
        if not free(dy, dx):
            dy, dx = dx, -dy                    # turn right
            if not free(dy, dx):
                return m
        y, x = y + dy, x + dx
        m[y, x] = True


def adversarial_masks(h: int, w: int) -> dict[str, np.ndarray]:
    """(h, w) bool masks that stress a tiled connected-component labelling:
    components that cross every tile seam many times, the most runs a row
    can hold, and the two trivial planes."""
    yy, xx = np.mgrid[0:h, 0:w]
    return {
        "spiral": spiral_mask(h, w),
        # full rows two apart, joined at alternating ends: one snake
        "serpentine": ((yy % 2 == 0) | ((yy % 4 == 1) & (xx == w - 1))
                       | ((yy % 4 == 3) & (xx == 0))),
        # one component 8-connected, all singletons 4-connected
        "checkerboard": (yy + xx) % 2 == 0,
        # one-pixel runs, w / 2 a row, on a spine
        "comb": (xx % 2 == 0) | (yy == 0),
        "full": np.ones((h, w), bool),
        "empty": np.zeros((h, w), bool),
    }
