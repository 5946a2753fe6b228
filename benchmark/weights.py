"""Weights from a seed, made on the device in one draw.

Both sides of a comparison get these same tensors: the program loads them,
the reference reads them. Ranges follow each leaf's role, so that the
network's activations keep a sensible scale and every BatchNorm fold moves
its conv:

  * conv and transposed-conv weights and biases: U(+-1/sqrt(fan_in)),
    torch's default;
  * BatchNorm: weight U(0.5, 1.5), bias U(-0.1, 0.1), running mean
    U(-0.1, 0.1), running variance U(0.5, 1.5);
  * normalized-conv kernels (``nconv*``, made positive by the network):
    U(0, 1), the Poisson initialiser's noise; the 1x1 output layer (cout 1)
    U(+-sqrt(6 / fan_in)), Kaiming's; their biases U(0, 0.02).
"""
from __future__ import annotations

import math

import torch


def _fan_in(name: str, shape) -> int:
    if name.endswith("conv_t.weight"):  # (cin, cout, kh, kw)
        return shape[0] * shape[2] * shape[3]
    return math.prod(shape[1:])


def _range(name: str, shapes: dict) -> tuple[float, float]:
    leaf = name.rsplit(".", 2)
    shape = shapes[name]
    if name.endswith(".bn.weight") or name.endswith(".bn.running_var"):
        return 0.5, 1.5
    if name.endswith(".bn.bias") or name.endswith(".bn.running_mean"):
        return -0.1, 0.1
    if "nconv" in leaf[-2]:
        if name.endswith(".bias"):
            return 0.0, 0.02
        if shape[0] == 1:
            b = math.sqrt(6.0 / _fan_in(name, shape))
            return -b, b
        return 0.0, 1.0
    weight = name if len(shape) == 4 else name[: -len("bias")] + "weight"
    b = 1.0 / math.sqrt(_fan_in(weight, shapes[weight]))
    return -b, b


def make(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of the given shapes (an ordered ``{name: shape}``)
    on ``device``, float32, from ``seed``."""
    shapes = {k: tuple(v) for k, v in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        lo, hi = _range(name, shapes)
        out[name] = (flat[off:off + n] * (hi - lo) + lo).view(shape)
        off += n
    return out
