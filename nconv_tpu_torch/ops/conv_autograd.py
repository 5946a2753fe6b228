"""Differentiable convolutions of the guided training graph.

Each is a ``torch.autograd.Function`` whose forward is a fused layer op
(a kernel on CUDA tensors, its plain version on CPU tensors) and whose
backward is the JAX package's hand-written one, on the gradient kernels of
:mod:`.convops`; a backward never reruns the forward.

Types follow the JAX backwards, with every cast explicit (autograd would
otherwise cast a returned gradient to its input's dtype silently): the ReLU
mask and ``d_b`` stay in the cotangent's dtype; ``d_x`` and ``d_w`` are
computed on the cotangent cast to the weight's dtype (the compute dtype:
f32, or bf16 in the mixed schedule, where the caller hands in a bf16 copy of
its f32 master weight); ``d_x`` is cast to each part's dtype, and ``d_w``
(f32 from K6) is rounded to the weight's dtype, as JAX's
``.astype(kernel.dtype)`` rounds it.

  * :func:`conv3x3_trainable` — 3x3 pad-1 conv over parts at stride 1 or 2,
    bias and ReLU optional. Ports ``_conv2d_bhcw_fwd/_bwd`` (the
    non-residual form) and ``_conv2d_bhcw_cat_bwd``
    (``nconv_tpu/ops/pallas_conv.py``) at stride 1, and the stacked
    encoder pair ``pallas_s2._s2_res_fwd_impl/_s2_res_bwd`` at stride 2
    (the caller stacks ``[main | centre-embedded 1x1 shortcut]``, see
    ``models/layers.py:stack_shortcut``). Forward K2; the ReLU mask is
    ``out > 0`` of the saved output; ``d_x`` is one input-gradient conv,
    K2's K x K form at stride 1 or K3's 3x3/s2 form at stride 2 (cropped
    to an odd input's size), sliced per part and skipped when no part needs
    it; ``d_w`` one K6 launch over all parts; ``d_b`` a plain sum.
  * :func:`conv_transpose4x4s2_trainable` — the 4x4/s2/p1 transpose conv over
    parts, bias and ReLU optional. Ports ``pallas_s2._ct_fwd_impl/_ct_bwd``.
    Forward K3; ``d_x`` K2's 4x4/s2 form, sliced per part; ``d_w`` K6 with
    the roles swapped; ``d_b`` a plain sum.

Under ``torch.no_grad()`` a Function is its forward alone, the serving
kernel: the model's layers call the Functions in every mode.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .convops import (
    conv2d_input_grad,
    conv2d_wgrad,
    conv3x3,
    conv3x3s2_input_grad,
    conv_transpose4x4s2,
    conv_transpose4x4s2_input_grad,
)


def _split(d_x, parts, needs):
    """``d_x`` sliced along channels into one gradient per part, in that
    part's dtype (None where a part needs none)."""
    out, off = [], 0
    for p, need in zip(parts, needs):
        out.append(d_x[:, off:off + p.shape[1]].to(p.dtype) if need else None)
        off += p.shape[1]
    return out


def _bias_grad(ctx, g):
    """``d_b``, summed in the cotangent's dtype, in the bias's dtype."""
    if ctx.bias_dtype is None or not ctx.needs_input_grad[1]:
        return None
    return g.sum(dim=(0, 2, 3)).to(ctx.bias_dtype)


class _Conv3x3Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, bias, stride, relu, out_dtype, *parts):
        out = conv3x3(parts, weight, bias, stride=stride, relu=relu, out_dtype=out_dtype)
        ctx.stride, ctx.relu, ctx.nparts = stride, relu, len(parts)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(weight, out, *parts)
        return out

    @staticmethod
    def backward(ctx, g):
        weight, out, *parts = ctx.saved_tensors
        if ctx.relu:
            g = g * (out > 0)
        gw = g.to(weight.dtype)
        needs = ctx.needs_input_grad[5:]
        d_parts = [None] * ctx.nparts
        if any(needs):
            if ctx.stride == 1:
                d_x = conv2d_input_grad(gw, weight, 1)
            else:
                h, w = parts[0].shape[2:]
                d_x = conv3x3s2_input_grad(gw, weight)[:, :, :h, :w]
            d_parts = _split(d_x, parts, needs)
        d_w = None
        if ctx.needs_input_grad[0]:
            d_w = conv2d_wgrad(parts, [gw], 3, stride=ctx.stride, padding=1).to(weight.dtype)
        return d_w, _bias_grad(ctx, g), None, None, None, *d_parts


def conv3x3_trainable(
    parts: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    relu: bool = False,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Differentiable :func:`~.convops.conv3x3` (no shortcut) over the
    channel concat of ``parts`` at stride 1 or 2."""
    return _Conv3x3Function.apply(weight, bias, stride, relu, out_dtype, *parts)


class _ConvTranspose4x4s2Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, bias, relu, *parts):
        out = conv_transpose4x4s2(parts, weight, bias, relu=relu)
        ctx.relu, ctx.nparts = relu, len(parts)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(weight, out, *parts)
        return out

    @staticmethod
    def backward(ctx, g):
        weight, out, *parts = ctx.saved_tensors
        if ctx.relu:
            g = g * (out > 0)
        gw = g.to(weight.dtype)
        needs = ctx.needs_input_grad[3:]
        d_parts = [None] * ctx.nparts
        if any(needs):
            d_parts = _split(conv_transpose4x4s2_input_grad(gw, weight), parts, needs)
        d_w = None
        if ctx.needs_input_grad[0]:
            d_w = conv2d_wgrad([gw], parts, 4, stride=2, padding=1).to(weight.dtype)
        return d_w, _bias_grad(ctx, g), None, *d_parts


def conv_transpose4x4s2_trainable(
    parts: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    relu: bool = False,
) -> torch.Tensor:
    """Differentiable :func:`~.convops.conv_transpose4x4s2` over the channel
    concat of ``parts``; weight (cin, cout, 4, 4)."""
    return _ConvTranspose4x4s2Function.apply(weight, bias, relu, *list(parts))
