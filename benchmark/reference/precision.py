"""Where a reference rounds, and to what.

A reference computes in float32 (TF32 off) and rounds a tensor to its
storage precision where the configuration stores it. A control runs the
same reference one precision lower. Every function here is plain torch and
runs alike on the CPU and the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude to 448),
    as an fp8 path stores a tensor."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) with its mantissa rounded to TF32's 10 bits, to
    nearest even: what the tensor cores read of an operand with TF32 on."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


STORE = {"f32": exact, "bf16": bf16, "fp8": fp8}


def exact_conv(x, w, bias=None, stride=1, padding=0):
    return F.conv2d(x, w, bias, stride, padding)


class _Tf32Conv(torch.autograd.Function):
    """conv2d whose forward and both backward convolutions read their
    operands rounded to TF32, as cuDNN does with TF32 allowed."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return F.conv2d(tf32(x), tf32(w), padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = conv2d_input(x.shape, tf32(w), tf32(g), padding=ctx.padding)
        gw = conv2d_weight(tf32(x), w.shape, tf32(g), padding=ctx.padding)
        return gx, gw, None


def tf32_conv(x, w, bias=None, stride=1, padding=0):
    if stride != 1:
        raise ValueError("the TF32 control convolves at stride 1")
    y = _Tf32Conv.apply(x, w, padding)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


CONV = {"f32": exact_conv, "tf32": tf32_conv}


def no_tf32() -> None:
    """Full float32 in cuDNN and cuBLAS for the rest of the process."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
