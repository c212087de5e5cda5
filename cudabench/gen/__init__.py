"""Seeded inputs, made on the device with one ``torch.Generator``.

Frozen copies of the port's synthetic generators (its
``utils/synthetic.py``), rewritten as a few large tensor calls so that a run
makes its inputs in milliseconds on the card:

- ``ridge_frames``: ``make_batch``'s concentric-ridge prints (centre jitter
  +-20 px, a random phase, an elliptic pad of 0.42 H x 0.40 W, sensor noise
  0.02), quantised to uint8 as a decoder hands frames over;
- ``user_templates``: ``users_gallery``'s templates: each user a random
  constellation of ``n_min`` minutiae, each sample a copy jittered by 1 px,
  so genuine pairs match. The points span the frame (40 px from each
  edge) where the original spans a fixed 40-220 px.

The same seed gives the same inputs on one device. ``digests.json`` holds
the CPU generator's output at a small size (``tests/test_gen_work.py``).
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def ridge_frames(g: torch.Generator, n: int, h: int, w: int) -> torch.Tensor:
    """(n, h, w) uint8 ridge prints from ``g``, on ``g``'s device."""
    dev = g.device
    u = torch.rand((n, 3), generator=g, device=dev)
    noise = torch.randn((n, h, w), generator=g, device=dev)
    cy = (h / 2 + u[:, 0] * 40.0 - 20.0)[:, None, None]
    cx = (w / 2 + u[:, 1] * 40.0 - 20.0)[:, None, None]
    phase = (u[:, 2] * 6.28)[:, None, None]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    r = torch.sqrt(((yy - cy) / 1.1) ** 2 + (xx - cx) ** 2)
    ang = torch.atan2(yy - cy, xx - cx)
    ridges = 0.5 + 0.5 * torch.cos(r / 4.5 + 2.0 * torch.sin(3 * ang) + phase)
    ell = ((yy - cy) / (0.42 * h)) ** 2 + ((xx - cx) / (0.40 * w)) ** 2 < 1
    img = torch.where(ell, 1.0 - 0.8 * ridges, 0.95)
    img = torch.clamp(img + 0.02 * noise, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)


# the preprocessing runner rounds each side of what it reads up to this
CANVAS_MULTIPLE = 32


def canvas_shape(h: int, w: int) -> tuple[int, int]:
    """The runner's canonical shape of (h, w) frames: each side rounded up
    to a multiple of ``CANVAS_MULTIPLE``."""
    m = CANVAS_MULTIPLE
    return h + (-h) % m, w + (-w) % m


def on_canvas(frames: torch.Tensor) -> torch.Tensor:
    """(n, h, w) frames zero-padded at the bottom and right to
    ``canvas_shape``, as the preprocessing runner pads what it reads."""
    h, w = frames.shape[-2:]
    hh, ww = canvas_shape(h, w)
    return torch.nn.functional.pad(frames, (0, ww - w, 0, hh - h))


def user_templates(g: torch.Generator, n_users: int, samples: int, k: int,
                   n_min: int, h: int, w: int) -> dict[str, torch.Tensor]:
    """(n_users * samples, k) templates keyed by the port's ``MinutiaeSet``
    field names, user-major (rows u * samples + s), on ``g``'s device."""
    dev = g.device
    span = torch.tensor([w - 80.0, h - 80.0], device=dev)
    base_xy = torch.rand((n_users, n_min, 2), generator=g, device=dev) * span + 40
    base_ori = (torch.rand((n_users, n_min), generator=g, device=dev) - 0.5) * math.pi
    base_ty = (torch.rand((n_users, n_min), generator=g, device=dev) > 0.5).to(torch.int32)
    base_q = 0.4 + 0.6 * torch.rand((n_users, n_min), generator=g, device=dev)
    jitter = torch.randn((n_users, samples, n_min, 2), generator=g, device=dev)
    n = n_users * samples

    def slots(v, fill=0):
        out = torch.full((n, k) + v.shape[3:], fill, dtype=v.dtype, device=dev)
        out[:, :n_min] = v.reshape((n, n_min) + v.shape[3:])
        return out

    rep = lambda v: v[:, None].expand((n_users, samples) + v.shape[1:])
    q = slots(rep(base_q))
    return dict(xy=slots(rep(base_xy) + jitter), minutia_type=slots(rep(base_ty)),
                orientation=slots(rep(base_ori)), quality=q, coherence=q.clone(),
                angular_stability=q.clone(),
                valid=slots(torch.ones((n_users, samples, n_min), dtype=torch.bool,
                                       device=dev), False))
