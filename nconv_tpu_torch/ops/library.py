"""The serving kernels as ``torch.library`` custom ops, for ``torch.export``.

A kernel launch is a ``ctypes`` call on raw data pointers
(:func:`nconv_tpu_torch.kernels.launch`), which a trace cannot record. So
while ``torch.export`` traces the deployed forward
(:func:`nconv_tpu_torch.runtime.export.export_guided`), each serving entry
goes through an op of the ``nconv_tpu_torch::`` namespace instead, the
port's form of a ``pallas_call`` inside a ``jax.export`` trace:

  * ``nconv2d_fused`` — K1 (:func:`.nconv.nconv2d_fused`); it always returns
    four tensors, the pooled pair empty (shape (0,)) without ``pool_out``;
  * ``conv3x3`` — K2 (:func:`.convops.conv3x3`): ``conv``, ``conv_tc`` or
    ``conv_thin`` by the same routing as the eager call;
  * ``conv_transpose4x4s2`` — K3 (:func:`.convops.conv_transpose4x4s2`);
  * ``conv3x3_chain2`` — K4 (:func:`.convops.conv3x3_chain2`).

``conv3x3``, ``conv_transpose4x4s2`` and ``conv3x3_chain2`` below are the
ops themselves (``out_dtype`` resolved by the caller); :func:`nconv2d_fused`
wraps its op to return two tensors, or four with ``pool_out``.

Each op has three implementations: on CUDA tensors the kernel path, launched
through ``kernels.launch`` (so :data:`~nconv_tpu_torch.kernels.LAUNCHES`
counts a program's launches as it counts the eager call's); on CPU tensors
the plain version; and a fake one that gives only the output's shape and
dtype, symbolic in the batch. Outputs are new contiguous tensors, never an
input or a view of one. Outside a trace the public functions call the
kernels directly and never reach these ops. The training forms are not
registered: an exported program is inference only.

Importing this module registers the ops; a process that loads a saved
program must import it first (:func:`nconv_tpu_torch.runtime.export.load_exported`
does).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from . import convops, nconv

__all__ = ["conv3x3", "conv3x3_chain2", "conv_transpose4x4s2", "nconv2d_fused"]

NAMESPACE = "nconv_tpu_torch"


def _empty_pair(like: Tensor) -> tuple[Tensor, Tensor]:
    return like.new_empty((0,)), like.new_empty((0,))


def _contiguous(*ts: Tensor) -> tuple[Tensor, ...]:
    return tuple(t.contiguous() for t in ts)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::nconv2d_fused", mutates_args=(), device_types="cuda")
def _nconv2d_fused_op(d_parts: list[Tensor], c_parts: list[Tensor], weight: Tensor, bias: Tensor,
                      padding: int, up2: list[bool], crop: int, pool_out: bool,
                      eps: float) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    outs = nconv._nconv2d_kernel(d_parts, c_parts, weight, bias, padding, up2, crop, pool_out, eps)
    return outs if pool_out else (*outs, *_empty_pair(outs[0]))


@_nconv2d_fused_op.register_kernel("cpu")
def _(d_parts, c_parts, weight, bias, padding, up2, crop, pool_out, eps):
    outs = _contiguous(*nconv.nconv2d_fused_plain(d_parts, c_parts, weight, bias, padding=padding, up2=up2,
                                                  crop=crop, pool_out=pool_out, eps=eps))
    return outs if pool_out else (*outs, *_empty_pair(outs[0]))


@_nconv2d_fused_op.register_fake
def _(d_parts, c_parts, weight, bias, padding, up2, crop, pool_out, eps):
    full = next(p for p, u in zip(d_parts, up2) if not u)
    b, _, h, w = full.shape
    cout, _, k, _ = weight.shape
    ho, wo = h + 2 * padding - k + 1 - 2 * crop, w + 2 * padding - k + 1 - 2 * crop
    dt = torch.float64 if full.dtype == torch.float64 else torch.float32
    out, conf = (full.new_empty((b, cout, ho, wo), dtype=dt) for _ in range(2))
    if not pool_out:
        return out, conf, *_empty_pair(out)
    return out, conf, *(full.new_empty((b, cout, ho // 2, wo // 2), dtype=dt) for _ in range(2))


def nconv2d_fused(d_parts, c_parts, weight, bias, *, padding, up2, crop, pool_out, eps):
    """:func:`.nconv.nconv2d_fused` as the op: ``(out, conf)``, plus the
    pooled pair with ``pool_out``."""
    outs = _nconv2d_fused_op(list(d_parts), list(c_parts), weight, bias, padding, [bool(u) for u in up2],
                             crop, pool_out, float(eps))
    return outs if pool_out else outs[:2]


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::conv3x3", mutates_args=(), device_types="cuda")
def conv3x3(parts: list[Tensor], weight: Tensor, bias: Optional[Tensor], stride: int, relu: bool,
            shortcut: Optional[Tensor], out_dtype: torch.dtype) -> Tensor:
    return convops._conv3x3_on_card(parts, weight, bias, stride, relu, shortcut, out_dtype)


@conv3x3.register_kernel("cpu")
def _(parts, weight, bias, stride, relu, shortcut, out_dtype):
    return convops.conv3x3_plain(parts, weight, bias, stride=stride, relu=relu, shortcut=shortcut,
                                 out_dtype=out_dtype).contiguous()


@conv3x3.register_fake
def _(parts, weight, bias, stride, relu, shortcut, out_dtype):
    b, _, h, w = parts[0].shape
    return parts[0].new_empty((b, weight.shape[0], (h - 1) // stride + 1, (w - 1) // stride + 1),
                              dtype=out_dtype)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::conv_transpose4x4s2", mutates_args=(), device_types="cuda")
def conv_transpose4x4s2(parts: list[Tensor], weight: Tensor, bias: Optional[Tensor], relu: bool) -> Tensor:
    return convops._conv_transpose4x4s2_on_card(parts, weight, bias, relu)


@conv_transpose4x4s2.register_kernel("cpu")
def _(parts, weight, bias, relu):
    return convops.conv_transpose4x4s2_plain(parts, weight, bias, relu=relu).contiguous()


@conv_transpose4x4s2.register_fake
def _(parts, weight, bias, relu):
    b, _, h, w = parts[0].shape
    return parts[0].new_empty((b, weight.shape[1], 2 * h, 2 * w))


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::conv3x3_chain2", mutates_args=(), device_types="cuda")
def conv3x3_chain2(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    return convops._conv3x3_chain2_on_card(x, w1, b1, w2, b2)


@conv3x3_chain2.register_kernel("cpu")
def _(x, w1, b1, w2, b2):
    return convops.conv3x3_chain2_plain(x, w1, b1, w2, b2).contiguous()


@conv3x3_chain2.register_fake
def _(x, w1, b1, w2, b2):
    b, _, h, w = x.shape
    return x.new_empty((b, w2.shape[0], h, w))
