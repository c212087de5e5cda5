"""Learning-rate schedules of the port (the JAX package's
``train/schedule.py`` and the one-cycle schedule of
``train/seg_train.py``), as functions of the optimizer's step count that
give the float32 value optax's schedules give, operation by operation in
float32 on the host:

- ``cosine_warmup_schedule``: ``optax.warmup_cosine_decay_schedule(
  init_value=0, ...)``, a linear warmup from 0 joined to a cosine decay,
  with ``decay_steps = max(total, warmup + 1)``;
- ``cosine_onecycle_schedule``: ``optax.cosine_onecycle_schedule``, a
  cosine rise from ``peak / div_factor`` to ``peak`` over ``pct_start`` of
  the steps, then a cosine fall to ``peak / (div_factor *
  final_div_factor)``.

optax evaluates a schedule at the count *before* the optimizer's increment,
so step 0 of an SSL run has lr 0 and moves no weight; ``train/optim.py``
does the same. With the shipped SSL config (3 epochs, 5 warmup epochs)
every step is in warmup.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def _cos32(x: np.float32) -> np.float32:
    """float32 cosine of a float32 argument, rounded once from float64."""
    return _F32(math.cos(float(x)))


class _Linear:
    """``optax.linear_schedule(init, end, steps)`` (polynomial, power 1)."""

    def __init__(self, init_value: float, end_value: float, steps: int):
        self.init, self.end, self.steps = init_value, end_value, steps

    def __call__(self, count: int) -> np.float32:
        if self.steps <= 0:
            return _F32(self.init)
        c = min(max(int(count), 0), self.steps)
        frac = _F32(1) - _F32(c) / _F32(self.steps)
        return _F32(self.init - self.end) * frac + _F32(self.end)


class _CosineDecay:
    """``optax.cosine_decay_schedule(init, decay_steps, alpha)``."""

    def __init__(self, init_value: float, decay_steps: int, alpha: float):
        if not decay_steps > 0:
            raise ValueError(f"cosine decay needs decay_steps > 0, got "
                             f"{decay_steps}")
        self.init, self.steps, self.alpha = init_value, decay_steps, alpha

    def __call__(self, count: int) -> np.float32:
        c = _F32(min(int(count), self.steps))
        cosine = _F32(0.5) * (_F32(1) + _cos32(_F32(math.pi) * c
                                               / _F32(self.steps)))
        decayed = _F32(1 - self.alpha) * cosine + _F32(self.alpha)
        return _F32(self.init) * decayed


class WarmupCosineSchedule:
    """``optax.warmup_cosine_decay_schedule``: the warmup before
    ``warmup_steps``, the decay of ``count - warmup_steps`` after."""

    def __init__(self, init_value: float, peak_value: float,
                 warmup_steps: int, decay_steps: int, end_value: float = 0.0):
        alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
        self.warmup_steps = warmup_steps
        self.warmup = _Linear(init_value, peak_value, warmup_steps)
        self.decay = _CosineDecay(peak_value, decay_steps - warmup_steps, alpha)

    def __call__(self, count: int) -> np.float32:
        if count < self.warmup_steps:
            return self.warmup(count)
        return self.decay(count - self.warmup_steps)


def cosine_warmup_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, end_lr_frac: float = 0.0):
    warmup_steps = max(1, warmup_steps)
    return WarmupCosineSchedule(0.0, base_lr, warmup_steps,
                                max(total_steps, warmup_steps + 1),
                                base_lr * end_lr_frac)


class CosineOnecycleSchedule:
    """``optax.cosine_onecycle_schedule``: optax's piecewise cosine
    interpolation between the cumulative products of the scales, its
    constants in float64 (numpy) and the count's arithmetic in float32."""

    def __init__(self, transition_steps: int, peak_value: float,
                 pct_start: float = 0.3, div_factor: float = 25.0,
                 final_div_factor: float = 1e4):
        if transition_steps <= 0:
            raise ValueError("a onecycle schedule needs transition_steps > 0")
        scales = {int(pct_start * transition_steps): div_factor,
                  int(transition_steps): 1.0 / (div_factor * final_div_factor)}
        bounds, factors = zip(*sorted(scales.items()))
        self.bounds = np.stack((0,) + bounds)
        self.values = np.cumprod(np.stack((peak_value / div_factor,)
                                          + factors))

    def __call__(self, count: int) -> np.float32:
        b, v = self.bounds, self.values
        if count >= b[-1]:
            return _F32(v[-1])
        k = int(np.searchsorted(b, count, side="right")) - 1
        pct = _F32(count - b[k]) / _F32(b[k + 1] - b[k])
        half = _F32((v[k] - v[k + 1]) / 2.0)
        return _F32(v[k + 1]) + half * (_cos32(_F32(math.pi) * pct) + _F32(1))


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    return CosineOnecycleSchedule(transition_steps, peak_value, pct_start,
                                  div_factor, final_div_factor)
