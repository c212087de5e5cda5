"""Weights across the two packages: the JAX package's flax variables
``{"params", "batch_stats"}`` (nested dicts of numpy arrays, as a
checkpoint holds them) to the port's ``state_dict`` and back.

The port's modules carry flax's auto-names (``backbone.FusedMBConv_3.
Conv_0``), so a leaf's path is its module's name and only the leaf changes:

- conv ``kernel`` HWIO -> ``weight`` OIHW (a depthwise (3, 3, 1, C) kernel
  becomes (C, 1, 3, 3) with ``groups=C``); Dense ``kernel`` (in, out) ->
  ``weight`` (out, in); ``bias`` stays;
- BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``, plus ``num_batches_tracked`` 0;
- ``WeightNormDense``'s ``v``/``g`` stay as they are ((in, out), (out,)).

A leaf of another name raises. ``load_jax_variables`` then holds the result
to the model's own ``state_dict``: a missing key, a left-over key or a shape
that differs raises, naming them.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

_BN_LEAVES = {"scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _state_from_jax(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"variable collections the port has none of: {extra}")
    stats = dict(_leaves(variables.get("batch_stats", {})))
    bn_modules = {path[:-1] for path in stats}
    out: OrderedDict = OrderedDict()
    for path, arr in _leaves(variables["params"]):
        module, leaf = ".".join(path[:-1]), path[-1]
        if path[:-1] in bn_modules:
            if leaf not in _BN_LEAVES:
                raise KeyError(f"BatchNorm leaf {'/'.join(path)}")
            out[f"{module}.{_BN_LEAVES[leaf]}"] = torch.from_numpy(arr.copy())
        elif leaf == "kernel" and arr.ndim == 4:
            out[f"{module}.weight"] = torch.from_numpy(
                arr.transpose(3, 2, 0, 1).copy())
        elif leaf == "kernel" and arr.ndim == 2:
            out[f"{module}.weight"] = torch.from_numpy(arr.T.copy())
        elif leaf in ("bias", "v", "g"):
            out[f"{module}.{leaf}"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"parameter {'/'.join(path)} of shape {arr.shape} "
                           "has no counterpart in the port")
    for path, arr in stats.items():
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"batch statistic {'/'.join(path)}")
        out[f"{module}.{_STAT_LEAVES[leaf]}"] = torch.from_numpy(arr.copy())
    for path in sorted(bn_modules):
        out[".".join(path) + ".num_batches_tracked"] = torch.tensor(0)
    return out


def _variables_from_state(state: dict) -> dict:
    bn_modules = {k.rsplit(".", 1)[0] for k in state
                  if k.endswith(".running_mean")}
    params: dict = {}
    stats: dict = {}

    def put(tree, module, leaf, value):
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[leaf] = value

    for key, t in state.items():
        module, leaf = key.rsplit(".", 1)
        # a copy: a CPU tensor's numpy view would follow later training
        arr = t.detach().cpu().numpy().copy()
        if module in bn_modules:
            if leaf == "num_batches_tracked":
                continue
            names = {"weight": "scale", "bias": "bias",
                     "running_mean": "mean", "running_var": "var"}
            tree = stats if leaf.startswith("running_") else params
            put(tree, module, names[leaf], arr)
        elif leaf == "weight" and arr.ndim == 4:
            put(params, module, "kernel", arr.transpose(2, 3, 1, 0).copy())
        elif leaf == "weight" and arr.ndim == 2:
            put(params, module, "kernel", arr.T.copy())
        elif leaf in ("bias", "v", "g"):
            put(params, module, leaf, arr)
        else:
            raise KeyError(f"state_dict entry {key} has no flax counterpart")
    return {"params": params, "batch_stats": stats}


def ssl_state_from_jax(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """The ``SSLModel`` ``state_dict`` of JAX ``SSLModel`` variables."""
    return _state_from_jax(variables)


def unet_state_from_jax(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """The ``NestedUNet`` ``state_dict`` of JAX ``NestedUNet`` variables."""
    return _state_from_jax(variables)


def ssl_variables_from_state(state: dict) -> dict:
    """The JAX ``{"params", "batch_stats"}`` tree of an ``SSLModel``
    ``state_dict`` (numpy leaves): what a checkpoint stores."""
    return _variables_from_state(state)


def unet_variables_from_state(state: dict) -> dict:
    """The JAX tree of a ``NestedUNet`` ``state_dict``."""
    return _variables_from_state(state)


def load_jax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Load JAX variables into ``model`` (an ``SSLModel`` or a
    ``NestedUNet``); raises on any missing or left-over key or shape that
    differs. Returns the model."""
    state = _state_from_jax(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"JAX variables do not fit {type(model).__name__}: "
                       f"missing {missing[:8]} ({len(missing)}), left over "
                       f"{extra[:8]} ({len(extra)})")
    bad = [(k, tuple(state[k].shape), tuple(v.shape)) for k, v in own.items()
           if state[k].shape != v.shape]
    if bad:
        raise ValueError(f"shapes differ (key, JAX, port): {bad[:8]}")
    model.load_state_dict(state, strict=True)
    return model


def params_tree_of(model: nn.Module, tensors) -> dict:
    """The flax params tree of ``tensors``, a list aligned with
    ``model.parameters()`` (an optimizer's moments, say)."""
    state = dict(zip((k for k, _ in model.named_parameters()), tensors))
    state.update(model.named_buffers())
    return _variables_from_state(state)["params"]


def params_list_of(model: nn.Module, tree: dict) -> list:
    """``params_tree_of``'s inverse: the list aligned with
    ``model.parameters()`` of a flax params tree."""
    stats = _variables_from_state(dict(model.named_buffers()))["batch_stats"]
    state = _state_from_jax({"params": tree, "batch_stats": stats})
    return [state[k] for k, _ in model.named_parameters()]
