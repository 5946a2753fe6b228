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
    :func:`~.convops.conv2d_input_grad` at stride 1 (f32: K2's K x K form;
    bf16: the tensor cores, reading ``weight`` flipped as stored) or K3's
    3x3/s2 form at stride 2 (cropped to an odd input's size), sliced per
    part and skipped when no part needs it; ``d_w`` one K6 launch over all
    parts; ``d_b`` a plain sum.
  * :func:`conv3x3_residual_trainable` — the fused residual form
    ``relu(conv3x3(x) + b) + conv1x1(x)`` at stride 1 or 2. Ports the
    residual form of ``_conv2d_bhcw_bwd`` (``pallas_conv.py:821-853``):
    forward K2's residual form; the backward recomputes only the shortcut
    (K2 on the centre-embedded 1x1 kernel alone, no ReLU) and recovers the
    ReLU mask as ``(out - short) > 0``, then runs the cotangent pair
    ``[g * mask | g]`` through one input-gradient conv (the stride-1 form
    of its dtype, or K3's 3x3/s2 form at stride 2) and one K6 launch
    against the stacked kernel ``[weight | centre-embedded shortcut]``. In
    bf16 the recovered mask can flip where ``|main + b|`` is below the
    shortcut's bf16 ulp, as JAX's own comment says (``:827-834``): the port
    computes the same function, flips included.
  * :func:`conv_transpose4x4s2_trainable` — the 4x4/s2/p1 transpose conv over
    parts, bias and ReLU optional. Ports ``pallas_s2._ct_fwd_impl/_ct_bwd``.
    Forward K3; ``d_x`` the 4x4 stride-2 conv of the cotangent
    (:func:`~.convops.conv_transpose4x4s2_input_grad`: f32 on K2's K x K
    form, bf16 on the tensor cores), sliced per part; ``d_w`` K6 with the
    roles swapped; ``d_b`` a plain sum.

Under ``torch.no_grad()`` a Function is its forward alone, the serving
kernel: the model's layers call the Functions in every mode.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

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
        d_parts = _input_grads(gw, weight, ctx.stride, parts, needs)
        d_w = None
        if ctx.needs_input_grad[0]:
            d_w = conv2d_wgrad(parts, [gw], 3, stride=ctx.stride, padding=1).to(weight.dtype)
        return d_w, _bias_grad(ctx, g), None, None, None, *d_parts


def _input_grads(gw, weight, stride, parts, needs, centre=0):
    """Each part's input cotangent of a 3x3 pad-1 conv at ``stride`` (one
    conv, sliced per part; None where a part needs none); ``centre``: the
    trailing channels of ``gw`` whose weights are centre-only
    (:func:`~.convops.conv3x3s2_input_grad`)."""
    if not any(needs):
        return [None] * len(parts)
    if stride == 1:
        d_x = conv2d_input_grad(gw, weight, 1)
    else:
        h, w = parts[0].shape[2:]
        d_x = conv3x3s2_input_grad(gw, weight, centre)[:, :, :h, :w]
    return _split(d_x, parts, needs)


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


class _Conv3x3ResidualFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, bias, shortcut, stride, out_dtype, *parts):
        out = conv3x3(parts, weight, bias, stride=stride, relu=True, shortcut=shortcut,
                      out_dtype=out_dtype)
        ctx.stride, ctx.nparts = stride, len(parts)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(weight, shortcut, out, *parts)
        return out

    @staticmethod
    def backward(ctx, g):
        weight, shortcut, out, *parts = ctx.saved_tensors
        centre = F.pad(shortcut, (1, 1, 1, 1))  # the 1x1 kernel as a 3x3 one's centre tap
        short = conv3x3(parts, centre, None, stride=ctx.stride, out_dtype=out.dtype)
        gm = g * ((out - short) > 0)
        g2 = torch.cat([gm, g], 1).to(weight.dtype)
        stacked = torch.cat([weight, centre])
        # g's channels meet the shortcut's weights, which are centre-only
        d_parts = _input_grads(g2, stacked, ctx.stride, parts, ctx.needs_input_grad[5:], centre=g.shape[1])
        d_w = d_sc = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            d_k = conv2d_wgrad(parts, [g2], 3, stride=ctx.stride, padding=1).to(weight.dtype)
            n = weight.shape[0]
            d_w = d_k[:n] if ctx.needs_input_grad[0] else None
            d_sc = d_k[n:, :, 1:2, 1:2].contiguous() if ctx.needs_input_grad[2] else None
        return d_w, _bias_grad(ctx, gm), d_sc, None, None, *d_parts


def conv3x3_residual_trainable(
    parts: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    shortcut: torch.Tensor,
    *,
    stride: int = 1,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Differentiable residual form of :func:`~.convops.conv3x3`:
    ``relu(conv3x3(x, weight) + bias) + conv1x1(x, shortcut)`` over the
    channel concat of ``parts`` at stride 1 or 2; ``shortcut`` (cout, cin,
    1, 1) in ``weight``'s dtype."""
    return _Conv3x3ResidualFunction.apply(weight, bias, shortcut, stride, out_dtype, *parts)


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
