"""The optimizer of the port's training loops: what optax supplies to the
JAX package, ``optax.chain(optax.clip_by_global_norm(c), optax.adamw(lr,
weight_decay=wd))``, or with ``optax.inject_hyperparams(optax.adamw)`` in
the segmentation trainer, on lists of tensors.

What follows optax to the operation:

- Clipping: the global norm is the square root of the sum over the leaves
  of each leaf's sum of squares; the gradients are scaled by ``(g /
  g_norm) * c`` only when ``g_norm >= c``.
  (``torch.nn.utils.clip_grad_norm_`` multiplies by ``c / (g_norm + 1e-6)``
  clamped to 1, which is not the same rule.)
- AdamW: b1 0.9, b2 0.999, eps 1e-8, eps_root 0; ``mu = (1 - b1) g + b1
  mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias corrections ``1 - b^count`` in
  float32 at the incremented count, ``mu_hat / (sqrt(nu_hat + eps_root) +
  eps)``, plus ``wd * p`` on every leaf (optax applies the decay with no
  mask: BatchNorm scales and every bias decay too), times ``-lr``.
  The schedule is evaluated at the count before the increment.
- The constants: with ``inject=False`` optax holds b1, b2 and wd as Python
  floats (``1 - b1`` taken in float64, then float32); injected, they are
  float32 arrays (``1 - b1`` taken in float32), and the lr is a float32
  in the state that a caller may scale (the segmentation plateau rule).

``to_flax`` / ``from_flax`` map the state to and from the pytree flax
serialises for the chain: ``{"0": {}, "1": {"count", "hyperparams":
{learning_rate, b1, b2, eps, eps_root, weight_decay}, "hyperparams_states",
"inner_state": {"0": {"count", "mu", "nu"}, "1": {}, "2": {}}}}`` for the
injected chain, ``hyperparams_states`` holding ``{"learning_rate":
{"count"}}`` when the lr is a schedule.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

_F32 = np.float32


@dataclass
class AdamWState:
    """The chain's state. ``count`` is adam's (``inner_state/0/count``);
    ``inject_count`` the injection's and ``schedule_count`` its schedule's
    (both move with ``count`` from a fresh state); ``hyperparams`` the
    injected float32 values."""
    count: int
    mu: list
    nu: list
    inject_count: int = 0
    schedule_count: int = 0
    hyperparams: dict = field(default_factory=dict)


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    weight_decay=weight_decay))``; ``inject=True`` wraps adamw in
    ``inject_hyperparams``. ``learning_rate`` is a float or a schedule (a
    function of the step count, ``train/schedule.py``)."""

    def __init__(self, grad_clip: float, learning_rate: float | Callable,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0,
                 inject: bool = False):
        self.grad_clip = grad_clip
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.inject = inject

    @property
    def scheduled(self) -> bool:
        return callable(self.learning_rate)

    def init(self, params) -> AdamWState:
        hp = {}
        if self.inject:
            hp = {"learning_rate": _F32(self.learning_rate(0) if self.scheduled
                                        else self.learning_rate),
                  "b1": _F32(self.b1), "b2": _F32(self.b2),
                  "eps": _F32(self.eps), "eps_root": _F32(self.eps_root),
                  "weight_decay": _F32(self.weight_decay)}
        return AdamWState(
            count=0, mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params], hyperparams=hp)

    def current_lr(self, state: AdamWState) -> np.float32:
        """The lr the next ``step`` applies."""
        if self.scheduled:
            return _F32(self.learning_rate(
                state.schedule_count if self.inject else state.count))
        if self.inject:
            return _F32(state.hyperparams["learning_rate"])
        return _F32(self.learning_rate)

    def _constants(self, state: AdamWState) -> dict:
        if self.inject:
            hp = state.hyperparams
            b1, b2 = _F32(hp["b1"]), _F32(hp["b2"])
            return dict(b1=b1, b2=b2, c1=_F32(1) - b1, c2=_F32(1) - b2,
                        eps=_F32(hp["eps"]), eps_root=_F32(hp["eps_root"]),
                        wd=_F32(hp["weight_decay"]))
        return dict(b1=_F32(self.b1), b2=_F32(self.b2),
                    c1=_F32(1 - self.b1), c2=_F32(1 - self.b2),
                    eps=_F32(self.eps), eps_root=_F32(self.eps_root),
                    wd=_F32(self.weight_decay))

    @torch.no_grad()
    def step(self, params, grads, state: AdamWState) -> np.float32:
        """Update ``params`` and ``state`` in place from ``grads`` (lists
        aligned with each other), without a host read of the device; returns
        the lr applied. Each optax operation is one ``torch._foreach_*``
        call over the leaves, in optax's order."""
        lr = self.current_lr(state)
        k = self._constants(state)
        dev = params[0].device
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        # optax: select(g_norm < c, t, (t / g_norm) * c)
        keep = norm < self.grad_clip
        one = torch.ones((), device=dev)
        grads = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip))
        count = state.count + 1
        bc1 = torch.tensor(_F32(1) - k["b1"] ** _F32(count), device=dev)
        bc2 = torch.tensor(_F32(1) - k["b2"] ** _F32(count), device=dev)
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, float(k["b1"]))
        torch._foreach_add_(mu, torch._foreach_mul(grads, float(k["c1"])))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, float(k["c2"]))
        torch._foreach_mul_(nu, float(k["b2"]))
        torch._foreach_add_(nu, sq)
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_add_(den, float(k["eps_root"]))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, float(k["eps"]))
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, torch._foreach_mul(params, float(k["wd"])))
        torch._foreach_mul_(upd, float(-lr))
        torch._foreach_add_(params, upd)
        state.count = count
        if self.inject:
            state.inject_count += 1
            state.hyperparams["learning_rate"] = lr
            if self.scheduled:
                state.schedule_count += 1
        return lr

    # --- flax's pytree of the chain's state --------------------------------

    def to_flax(self, state: AdamWState, tree_of: Callable) -> dict:
        """The state as flax serialises it; ``tree_of(list)`` maps a list
        of tensors aligned with the parameters to the flax params tree."""
        adam = {"count": np.asarray(state.count, np.int32),
                "mu": tree_of(state.mu), "nu": tree_of(state.nu)}
        if not self.inject:
            last = ({"count": np.asarray(state.count, np.int32)}
                    if self.scheduled else {})
            return {"0": {}, "1": {"0": adam, "1": {}, "2": last}}
        hp = {k: np.asarray(v, np.float32)
              for k, v in state.hyperparams.items()}
        if self.scheduled:     # optax lists a scheduled hyperparameter last
            hp = {**{k: v for k, v in hp.items() if k != "learning_rate"},
                  "learning_rate": hp["learning_rate"]}
        sched = ({"learning_rate": {"count": np.asarray(state.schedule_count,
                                                        np.int32)}}
                 if self.scheduled else {})
        return {"0": {}, "1": {
            "count": np.asarray(state.inject_count, np.int32),
            "hyperparams": hp, "hyperparams_states": sched,
            "inner_state": {"0": adam, "1": {}, "2": {}}}}

    def from_flax(self, tree: dict, tensors_of: Callable,
                  device=None) -> AdamWState:
        """The state of a flax pytree ``to_flax`` writes (or the JAX
        package's checkpoint holds); ``tensors_of(tree)`` maps a flax
        params tree to the list aligned with the parameters."""
        chain = tree["1"]
        adam = chain["inner_state"]["0"] if self.inject else chain["0"]
        move = lambda ts: [t.to(device) for t in ts]
        state = AdamWState(count=int(adam["count"]),
                           mu=move(tensors_of(adam["mu"])),
                           nu=move(tensors_of(adam["nu"])))
        if self.inject:
            state.inject_count = int(chain["count"])
            state.hyperparams = {k: _F32(v)
                                 for k, v in chain["hyperparams"].items()}
            lr_state = chain["hyperparams_states"].get("learning_rate")
            state.schedule_count = int(lr_state["count"]) if lr_state else 0
        return state
