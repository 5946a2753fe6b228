"""Carry weights of the JAX models over to the port.

The JAX variable trees (``{'params': ..., 'batch_stats': ...}`` as nested
dicts of arrays) map onto the port's state dicts by module path:

  * ``Conv_0`` -> ``conv``, ``Conv_1`` -> ``shortcut`` (the RGB encoder's
    1x1), ``ConvTranspose_0`` -> ``conv_t``, ``BatchNorm_0/BatchNorm_0`` ->
    ``bn``;
  * conv kernels HWIO -> OIHW; transpose-conv kernels HWIO (I = input
    channels of the op) -> torch's (cin, cout, kh, kw);
  * BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``;
  * NConv kernels stay raw (HWIO -> OIHW only): the port applies ``pos_fn``
    itself, as the JAX model does.

Folded trees (``fold_batchnorm_variables``) map the same way onto a
``fold_bn=True`` model.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_MODULES = {"Conv_0": "conv", "Conv_1": "shortcut", "ConvTranspose_0": "conv_t"}
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))


def _key(path: tuple[str, ...], value) -> tuple[str, torch.Tensor]:
    *mods, leaf = path
    names, i, bn = [], 0, False
    while i < len(mods):
        if mods[i] == "BatchNorm_0":  # flax nests BatchNorm_0/BatchNorm_0
            names.append("bn")
            bn = True
            i += 2 if i + 1 < len(mods) and mods[i + 1] == "BatchNorm_0" else 1
            continue
        names.append(_MODULES.get(mods[i], mods[i]))
        i += 1
    t = _tensor(value)
    if bn:
        return ".".join(names + [_BN_LEAVES[leaf]]), t
    if leaf == "kernel":
        order = (2, 3, 0, 1) if names[-1] == "conv_t" else (3, 2, 0, 1)
        return ".".join(names + ["weight"]), t.permute(order).contiguous()
    return ".".join(names + [leaf]), t


def from_jax_variables(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``GuidedDepthNet`` (or ``NConvUNet``) variables -> the port's
    state dict for the same model (CPU float32 tensors)."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(tree.get(coll, {})):
            k, t = _key(path, v)
            sd[k] = t
    return sd


def from_jax_unguided_variables(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``NConvUNet`` variables -> the port's ``NConvUNet`` state dict
    (the same mapping; named for callers holding a step-1 tree)."""
    return from_jax_variables(tree)
