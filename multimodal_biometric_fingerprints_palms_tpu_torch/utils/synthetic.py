"""Synthetic fingerprint-like images, numpy only (no file, no network).

``make_batch`` is the port's copy of the root ``bench.py``'s generator, the
JAX package's benchmark input: concentric-ridge prints at PolyU size.
``blob_prints`` is a copy of ``tests/test_end_to_end_eer.py``'s ``_print``:
the same ridges with square blobs punched in, which leave >= 8 minutiae
after quality filtering (``make_batch``'s prints keep only 1-8, in the JAX
package and in the port alike). ``users_gallery`` is a copy of the matcher
benchmark's template gallery (``benchmarks/bench_matching.py``).
``tests/test_torch_synthetic.py`` holds all three equal to their originals.

``protocol_print`` and ``degrade_session`` are the Gabor EER protocol's
generator (``benchmarks/gabor_eer.py``'s ``_print`` and ``_degrade``): a
blob print as uint8, and its NIST-style second session (rigid placement,
blur, contrast loss, smudges, sensor noise). The JAX script degrades with
OpenCV; this copy warps with the port's ``ops.geometry.affine_warp`` and
blurs with ``ops.filters.gaussian_blur_cv`` (both imported when called,
so importing this module needs numpy only) and fills its smudges with
numpy, so its second sessions are not the JAX script's images.

``family_params`` and ``family_render`` are the SSL-quality protocol's
generator (``benchmarks/ssl_at_scale.py``'s ``family_params`` and
``render``): ``N_FAMILIES`` ridge-pattern families (frequency band, flow
style, curvature), an id drawn from its family, each impression jittered;
the same generator calls in the same order give the same images.
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


def protocol_print(seed: int, phase: float = 0.0, h: int = 320,
                   w: int = 256) -> np.ndarray:
    """(h, w) uint8 blob print of the Gabor EER protocol: every print shares
    the global ridge field, only the blob constellations differ."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.sqrt(((yy - h / 2) / 1.1) ** 2 + (xx - w / 2) ** 2)
    ang = np.arctan2(yy - h / 2, xx - w / 2)
    ridges = 0.5 + 0.5 * np.cos(r / 4.5 + 2.0 * np.sin(3 * ang) + phase)
    blobs = np.zeros((h, w), np.float32)
    for _ in range(110):
        by, bx = g.integers(40, h - 40), g.integers(40, w - 40)
        rr = g.integers(2, 6)
        blobs[by - rr:by + rr, bx - rr:bx + rr] = 1.0
    ell = (((yy - h / 2) / (0.42 * h)) ** 2
           + ((xx - w / 2) / (0.40 * w)) ** 2) < 1
    img = np.where(ell, 1.0 - 0.8 * ridges * (1 - 0.9 * blobs), 0.95)
    return (np.clip(img + g.normal(0, 0.02, (h, w)), 0, 1) * 255
            ).astype(np.uint8)


def _rotation_matrix(cx: float, cy: float, degrees: float) -> np.ndarray:
    """cv2.getRotationMatrix2D((cx, cy), degrees, 1.0), float64."""
    a = np.deg2rad(degrees)
    alpha, beta = np.cos(a), np.sin(a)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fill_ellipse(f: np.ndarray, cx: int, cy: int, ax: int, ay: int,
                  degrees: float, value: float) -> None:
    """Set the pixels of a filled ellipse (semi-axes ``ax`` along its own
    x, ``ay`` along its y, rotated by ``degrees``) to ``value``."""
    yy, xx = np.mgrid[0:f.shape[0], 0:f.shape[1]]
    dx, dy = xx - cx, yy - cy
    a = np.deg2rad(degrees)
    u = dx * np.cos(a) + dy * np.sin(a)
    v = -dx * np.sin(a) + dy * np.cos(a)
    f[(u / ax) ** 2 + (v / ay) ** 2 <= 1.0] = value


def degrade_session(img: np.ndarray, seed: int,
                    severity: float = 1.0) -> np.ndarray:
    """NIST-style second session of a (h, w) uint8 print: random rigid
    placement, optic blur, contrast loss, occlusion smudges and zero-mean
    sensor noise, each scaled by ``severity``; the random draws are the JAX
    script's, in its order. Returns uint8."""
    import torch
    from ..ops.filters import gaussian_blur_cv
    from ..ops.geometry import affine_warp
    g = np.random.default_rng(1000 + seed)
    s = float(severity)
    h, w = img.shape
    theta = g.uniform(-12, 12) * s
    tx, ty = g.uniform(-10, 10, 2) * s
    m = _rotation_matrix(w / 2, h / 2, theta)
    m[:, 2] += (tx, ty)
    warped = affine_warp(torch.from_numpy(img.astype(np.float32)), m,
                         fill=242.0)
    out = np.clip(np.round(warped.numpy()), 0, 255).astype(np.uint8)
    f = out.astype(np.float32) / 255.0
    if s > 0.2:
        f = gaussian_blur_cv(torch.from_numpy(f), 5, max(1e-3, 1.0 * s),
                             border="mirror").numpy()
    f = 0.5 + (1.0 - 0.45 * s) * (f - 0.5)         # contrast loss
    for _ in range(int(round(6 * s))):             # smudges
        cy, cx = g.integers(30, h - 30), g.integers(30, w - 30)
        ax_, ay_ = int(g.integers(8, 26)), int(g.integers(6, 18))
        _fill_ellipse(f, int(cx), int(cy), ax_, ay_,
                      float(g.uniform(0, 180)), float(g.uniform(0.55, 0.8)))
    f = f + g.normal(0, 0.10 * s, (h, w)).astype(np.float32)
    return (np.clip(f, 0, 1) * 255).astype(np.uint8)


N_FAMILIES = 8


def family_params(rng: np.random.Generator, fam: int) -> dict:
    """Family = a region of pattern space (frequency x style x curvature)."""
    return dict(
        freq=2.5 + 0.9 * fam + rng.uniform(-0.15, 0.15),
        style=fam % 4,           # 0 rings, 1 spiral, 2 waves, 3 saddle
        curve=0.4 + 0.15 * (fam // 4),
    )


def family_render(rng: np.random.Generator, p: dict, h: int = 320,
                  w: int = 256) -> np.ndarray:
    """One (h, w) uint8 impression of a family-parameterised id."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = h / 2 + rng.uniform(-25, 25)
    cx = w / 2 + rng.uniform(-20, 20)
    u, v = (yy - cy) / 100.0, (xx - cx) / 100.0
    r = np.hypot(u, v)
    ang = np.arctan2(u, v)
    ph = rng.uniform(0, 6.28)
    if p["style"] == 0:
        field = r * p["freq"] * 6.28
    elif p["style"] == 1:
        field = (r * p["freq"] + p["curve"] * ang) * 6.28
    elif p["style"] == 2:
        field = (u * p["freq"] + p["curve"] * np.sin(2 * v)) * 6.28
    else:
        field = (u * v * p["curve"] * 4 + r * p["freq"]) * 6.28
    img = 0.5 + 0.45 * np.cos(field + ph)
    ell = (u / 1.4) ** 2 + (v / 1.15) ** 2 < 1.0
    img = np.where(ell, img, 0.93)
    img = img + rng.normal(0, 0.04, img.shape)
    gain = rng.uniform(0.85, 1.1)
    return (np.clip(img * gain, 0, 1) * 255).astype(np.uint8)
