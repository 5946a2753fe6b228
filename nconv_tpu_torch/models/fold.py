"""BatchNorm folding for the eval graph.

Every BatchNorm normalizes the conv right before it, so at eval it folds in:

    g      = weight / sqrt(running_var + eps)
    conv'  = conv * g            (over the conv's output-channel axis)
    bias'  = bn_bias + (conv_bias - running_mean) * g

In a port state dict, BN ``P.bn.*`` folds into ``P.conv.weight`` (OIHW,
output axis 0) or ``P.conv_t.weight`` (transpose conv, (cin, cout, kh, kw),
output axis 1), whose ``bias`` it creates or updates.
"""
from __future__ import annotations

from typing import Mapping

import torch

BN_EPS = 1e-5  # torch BatchNorm2d default, as layers._ChannelBN uses

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def fold_batchnorm_state(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Unfolded state dict -> state dict of the ``fold_bn=True`` model."""
    out = dict(state)
    prefixes = [k[: -len(".bn.running_mean")] for k in state if k.endswith(".bn.running_mean")]
    for p in prefixes:
        bn = {leaf: out.pop(f"{p}.bn.{leaf}").float() for leaf in _BN_LEAVES}
        out.pop(f"{p}.bn.num_batches_tracked", None)
        transpose = f"{p}.conv_t.weight" in out
        conv = f"{p}.conv_t" if transpose else f"{p}.conv"
        kernel = out[f"{conv}.weight"]
        g = bn["weight"] / torch.sqrt(bn["running_var"] + BN_EPS)
        shape = (1, -1, 1, 1) if transpose else (-1, 1, 1, 1)
        out[f"{conv}.weight"] = (kernel * g.view(shape)).to(kernel.dtype)
        base = out.get(f"{conv}.bias")
        base = 0.0 if base is None else base
        out[f"{conv}.bias"] = (bn["bias"] + (base - bn["running_mean"]) * g).to(kernel.dtype)
    return out


def maybe_fold(model, state: Mapping[str, torch.Tensor]):
    """``(model, state) -> (model', state')`` with every BatchNorm folded
    when the model is not folded yet and the state carries BN statistics."""
    if not model.fold_bn and any(k.endswith(".bn.running_mean") for k in state):
        return model.folded(), fold_batchnorm_state(state)
    return model, dict(state)
