"""On-device contrastive augmentations for SSL training (the JAX package's
``classifier/augment_device.py``), in torch on the tensor's device.

Each image of a (B, H, W) float batch in [0, 1] becomes one
(image_size, image_size) view:

- rotation (p=0.8 uniform +-15 deg, else a multiple of 90), flips (lr
  p=0.5, ud p=0.3), a random crop of scale 0.8-1.0 resized to
  ``image_size``, composed into one source-coordinate map, sampled
  bilinearly through the flat-index gather of the JAX function (not
  ``grid_sample``, whose coordinate conventions differ), with
  reflect-101 folding of float coordinates (``fmod`` and a shift, as
  ``jnp.mod`` computes);
- brightness/contrast jitter (p=0.5) and gaussian noise (p=0.5, sigma
  0.015) elementwise.

The draws are ``jax.random``'s: image ``i`` takes ``split(fold_in(rng, i),
13)``. The 13 B scalars (uniform, randint) come from ``utils.threefry`` on
the host, over all the images' keys at once, bit for bit; the per-pixel
noise, ``jax.random.normal`` over (image_size, image_size), is drawn by the
same threefry on the tensor's device (``utils.threefry.normal_tensor``:
JAX's bits, ``erfinv`` within an ulp or so of XLA's). The trigonometry of
the angle runs on the host in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import threefry

_F32 = np.float32


def draws(rng, n: int, h: int, w: int, image_size: int) -> dict:
    """The per-image scalars of ``_augment_one`` for ``n`` images of
    (h, w), as float32 / bool numpy arrays, and the noise keys."""
    k = threefry.split(threefry.fold_in(rng, np.arange(n)), 13)  # (n, 13, 2)
    (r_ang, r_mode, r_ninety, r_lr, r_ud, r_scale, r_ox, r_oy, r_bc,
     r_alpha, r_beta, r_donoise, r_noise) = (k[:, j] for j in range(13))
    _uniform = lambda keys, lo=0.0, hi=1.0: threefry.uniform_from(
        keys, (), lo, hi)
    ang_small = _uniform(r_ang, -15.0, 15.0)
    ang_ninety = _F32(90.0) * threefry.randint(r_ninety, (), 0, 4).astype(
        np.float32)
    use_small = _uniform(r_mode) < _F32(0.8)
    theta = (np.where(use_small, ang_small, ang_ninety).astype(np.float32)
             * _F32(np.pi / 180))
    scale = _uniform(r_scale, 0.8, 1.0)
    crop = scale * _F32(min(h, w))
    return dict(
        theta=theta, cos=np.cos(theta), sin=np.sin(theta),
        flip_lr=_uniform(r_lr) < _F32(0.5), flip_ud=_uniform(r_ud) < _F32(0.3),
        crop=crop, ox=_uniform(r_ox) * (_F32(w) - crop),
        oy=_uniform(r_oy) * (_F32(h) - crop),
        step=crop / _F32(image_size),
        do_bc=_uniform(r_bc) < _F32(0.5),
        alpha=_uniform(r_alpha, 0.8, 1.2), beta=_uniform(r_beta, -0.1, 0.1),
        do_noise=_uniform(r_donoise) < _F32(0.5), noise_keys=r_noise)


def _reflect101(coord: torch.Tensor, n: int) -> torch.Tensor:
    """Fold float coordinates into [0, n-1], cv2 BORDER_REFLECT_101 style
    (``jnp.mod``: ``fmod``, then a shift into the divisor's sign)."""
    period = 2.0 * (n - 1)
    c = torch.fmod(coord, period)
    c = torch.where((c != 0) & (c < 0), c + period, c)
    return torch.where(c > (n - 1), period - c, c)


def augment_batch(imgs: torch.Tensor, rng, image_size: int = 224
                  ) -> torch.Tensor:
    """(B, H, W) float32 in [0, 1] -> (B, image_size, image_size) views on
    ``imgs``' device; ``rng`` is a ``utils.threefry`` key. Call twice with
    different keys for a two-view batch."""
    b, h, w = imgs.shape
    dev = imgs.device
    d = draws(rng, b, h, w, image_size)
    col = lambda name: torch.from_numpy(np.asarray(d[name])).to(dev)[:, None, None]
    ii = torch.arange(image_size, dtype=torch.float32, device=dev)
    step = col("step")
    gy = col("oy") + (ii[None, :, None] + 0.5) * step - 0.5
    gx = col("ox") + (ii[None, None, :] + 0.5) * step - 0.5
    shape = (b, image_size, image_size)
    gy, gx = gy.expand(shape), gx.expand(shape)
    gx = torch.where(col("flip_lr"), (w - 1) - gx, gx)
    gy = torch.where(col("flip_ud"), (h - 1) - gy, gy)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = col("cos"), col("sin")
    sx = cos * (gx - cx) - sin * (gy - cy) + cx
    sy = sin * (gx - cx) + cos * (gy - cy) + cy
    sx = _reflect101(sx, w)
    sy = _reflect101(sy, h)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    x0i = torch.clamp(x0, 0, w - 2).to(torch.int64)
    y0i = torch.clamp(y0, 0, h - 2).to(torch.int64)
    flat = imgs.reshape(b, -1)
    base = (y0i * w + x0i).reshape(b, -1)
    take = lambda off: torch.gather(flat, 1, base + off).reshape(shape)
    v00, v01, v10, v11 = take(0), take(1), take(w), take(w + 1)
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    out = torch.where(col("do_bc"),
                      torch.clamp(col("alpha") * out + col("beta"), 0.0, 1.0),
                      out)
    noise = 0.015 * threefry.normal_tensor(d["noise_keys"],
                                           (image_size, image_size), dev)
    return torch.where(col("do_noise"),
                       torch.clamp(out + noise, 0.0, 1.0), out)
