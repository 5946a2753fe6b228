"""Building blocks of the guided network (NCHW).

Every conv takes its input as a list of parts (a logical channel concat
that is never materialized) and runs in a compute ``dtype``: parts are
rounded to it, arithmetic is f32, the output is stored in it. Weights are
f32 masters: each call hands the conv a copy cast to the compute dtype
inside the autograd graph (:meth:`_ConvParams.params`), as the JAX package
casts its f32 params on every call, so in bf16 the weight gradient is
rounded to bf16 and widened back to f32. A model built for serving with BN
folded instead rounds its weights once, when it loads them
(:func:`round_weights_`), and the convs read them as they are held.
Blocks built with ``fold_bn=True`` hold BatchNorm already folded into the
conv (see :mod:`.fold`) and run as one fused kernel each; unfolded blocks
run conv, :class:`_ChannelBN` and ReLU in turn.

Every conv runs through its autograd Function (:mod:`..ops.conv_autograd`),
whose forward is the fused op.
:class:`_ChannelBN` follows ``self.training``: batch statistics and
running-average updates in train mode, the running statistics in eval
mode.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_autograd import (
    conv3x3_residual_trainable,
    conv3x3_trainable,
    conv_transpose4x4s2_trainable,
)
from ..ops.convops import conv3x3_chain2

# the running statistics' decay, the JAX package's ``_ChannelBN.momentum``
_BN_MOMENTUM = 0.9


def _parts(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to(parts, dtype):
    # uint8 frames enter the first conv as they are and are decoded on load
    return [p if p.dtype == torch.uint8 else p.to(dtype) for p in parts]


def _uniform(shape, bound, generator, device):
    return nn.Parameter(((torch.rand(shape, generator=generator) * 2 - 1) * bound).to(device))


class _ConvParams(nn.Module):
    """A conv kernel ``shape`` and its bias (cout,), f32, with torch's
    default init U(+-1/sqrt(fan_in))."""

    def __init__(self, shape, fan_in, cout, bias, generator, device):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = _uniform(shape, bound, generator, device)
        self.bias = _uniform((cout,), bound, generator, device) if bias else None
        self.held_at = None  # the dtype round_weights_ rounded them to

    def params(self, dtype):
        """(weight, bias) as the conv reads them in ``dtype``: as held when
        :func:`round_weights_` rounded them to ``dtype``, else cast to it
        (a no-op in f32 and f64)."""
        if self.held_at == dtype:
            return self.weight, self.bias
        return self.weight.to(dtype), None if self.bias is None else self.bias.to(dtype)


class Conv(_ConvParams):
    """Conv weights (cout, cin, k, k) and bias."""

    def __init__(self, cin, cout, kernel_size=3, *, bias=True, generator, device):
        super().__init__((cout, cin, kernel_size, kernel_size), cin * kernel_size * kernel_size, cout,
                         bias, generator, device)

    def forward(self, x, *, dtype, stride=1, relu=False, shortcut=None):
        """3x3 pad-1 conv of ``x`` (a tensor or a list of parts)."""
        return _conv3x3(_to(_parts(x), dtype), *self.params(dtype), dtype=dtype,
                        stride=stride, relu=relu, shortcut=shortcut)


def _conv3x3(parts, weight, bias, *, dtype, stride=1, relu=False, shortcut=None):
    """The fused conv op through its autograd Function (the residual form,
    ``relu`` implied, through its own)."""
    if shortcut is None:
        return conv3x3_trainable(parts, weight, bias, stride=stride, relu=relu, out_dtype=dtype)
    if not relu:
        raise ValueError("the residual form is relu(conv + b) + shortcut")
    return conv3x3_residual_trainable(parts, weight, bias, shortcut, stride=stride, out_dtype=dtype)


class ConvTranspose(_ConvParams):
    """4x4/s2/p1 transpose-conv weights (cin, cout, 4, 4) (fan_in = 16 *
    cin) and bias."""

    def __init__(self, cin, cout, *, bias=True, generator, device):
        super().__init__((cin, cout, 4, 4), 16 * cin, cout, bias, generator, device)

    def forward(self, x, *, dtype, relu):
        return conv_transpose4x4s2_trainable(_to(_parts(x), dtype), *self.params(dtype), relu=relu)


class _ChannelBN(nn.Module):
    """BatchNorm over axis 1 (the JAX package's ``_ChannelBN``): the
    per-channel ``rsqrt(var + eps) * weight`` is formed in at least f32,
    then the elementwise ``(x - mean) * mul + bias`` runs in the input dtype.

    Eval mode normalizes with the running statistics. Train mode uses the
    batch's: the mean and the biased variance ``E[x^2] - E[x]^2`` over
    (B, H, W), accumulated in at least f32, and moves the running
    statistics to ``0.9 * running + 0.1 * batch``. (The
    running variance is the biased one, as flax keeps it; ``F.batch_norm``
    would store the unbiased.)"""

    def __init__(self, channels: int, eps: float = 1e-5, *, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x):
        dt, shape = x.dtype, (1, -1, 1, 1)
        if self.training:
            acc = torch.promote_types(dt, torch.float32)
            mean = x.mean((0, 2, 3), dtype=acc)
            var = (x * x).mean((0, 2, 3), dtype=acc) - mean * mean
            with torch.no_grad():
                self.running_mean.copy_(_BN_MOMENTUM * self.running_mean + (1 - _BN_MOMENTUM) * mean)
                self.running_var.copy_(_BN_MOMENTUM * self.running_var + (1 - _BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.to(dt).view(shape)) * mul.to(dt).view(shape) + self.bias.to(dt).view(shape)


class ConvBlock(nn.Module):
    """conv3x3 + bias + ReLU, no norm."""

    def __init__(self, cin, cout, *, generator, device):
        super().__init__()
        self.conv = Conv(cin, cout, generator=generator, device=device)

    def forward(self, x, *, dtype):
        return self.conv(x, dtype=dtype, relu=True)


class Basic2d(nn.Module):
    """conv3x3 + BN + ReLU; with ``fold_bn`` the conv carries the folded
    BN as its bias and the block is one fused conv + ReLU."""

    def __init__(self, cin, cout, *, fold_bn=False, generator, device):
        super().__init__()
        self.fold_bn = fold_bn
        self.conv = Conv(cin, cout, bias=fold_bn, generator=generator, device=device)
        self.bn = None if fold_bn else _ChannelBN(cout, device=device)

    def forward(self, x, *, dtype):
        if self.fold_bn:
            return self.conv(x, dtype=dtype, relu=True)
        return torch.relu(self.bn(self.conv(x, dtype=dtype)))


class Basic2dTrans(nn.Module):
    """4x4/s2/p1 transpose conv + BN + ReLU (fused when BN is folded)."""

    def __init__(self, cin, cout, *, fold_bn=False, generator, device):
        super().__init__()
        self.fold_bn = fold_bn
        self.conv_t = ConvTranspose(cin, cout, bias=fold_bn, generator=generator, device=device)
        self.bn = None if fold_bn else _ChannelBN(cout, device=device)

    def forward(self, x, *, dtype):
        if self.fold_bn:
            return self.conv_t(x, dtype=dtype, relu=True)
        return torch.relu(self.bn(self.conv_t(x, dtype=dtype, relu=False)))


def stack_shortcut(weight, bias, shortcut):
    """The RGB encoder's 3x3 conv ``(weight, bias)`` and its 1x1 ``shortcut``
    as one 3x3 pad-1 conv with the outputs ``[main | shortcut]``: the 1x1
    kernel as the centre tap of a 3x3 one (same stride, same output grid),
    bias ``[bias | 0]``. Differentiable, so the shortcut's gradient is the
    centre tap of its half and the bias's the main half's."""
    return torch.cat([weight, F.pad(shortcut, (1, 1, 1, 1))]), torch.cat([bias, torch.zeros_like(bias)])


class RGBEncoder(nn.Module):
    """Residual encoder stage ``relu(BN(conv3x3_s(x))) + conv1x1_s(x)``.
    Folded, the whole block is one kernel launch with the shortcut in the
    epilogue. Unfolded, the main conv and the shortcut run as one conv with
    stacked outputs (:func:`stack_shortcut`); BN and ReLU apply to the main
    half, and the shortcut half is added after them."""

    def __init__(self, cin, cout, stride, *, fold_bn=False, generator, device):
        super().__init__()
        self.stride, self.fold_bn = stride, fold_bn
        self.conv = Conv(cin, cout, generator=generator, device=device)
        self.bn = None if fold_bn else _ChannelBN(cout, device=device)
        self.shortcut = Conv(cin, cout, 1, bias=False, generator=generator, device=device)

    def forward(self, x, *, dtype):
        sc, _ = self.shortcut.params(dtype)
        if self.fold_bn:
            return self.conv(x, dtype=dtype, stride=self.stride, relu=True, shortcut=sc)
        w, b = stack_shortcut(*self.conv.params(dtype), sc)
        y = _conv3x3(_to(_parts(x), dtype), w, b, dtype=dtype, stride=self.stride)
        f = self.conv.weight.shape[0]
        return torch.relu(self.bn(y[:, :f])) + y[:, f:]


class Conv3x3Head(nn.Module):
    """3x3 -> 1 channel, no bias: the per-scale residual-depth head."""

    def __init__(self, cin, *, generator, device):
        super().__init__()
        self.conv = Conv(cin, 1, bias=False, generator=generator, device=device)

    def forward(self, x, *, dtype):
        return self.conv(x, dtype=dtype)


def conv_chain(x, first: ConvBlock, second: ConvBlock, *, dtype):
    """Two ConvBlocks as one kernel launch (intermediate kept on chip);
    forward only (K4 has no backward)."""
    (w1, b1), (w2, b2) = first.conv.params(dtype), second.conv.params(dtype)
    return conv3x3_chain2(x.to(dtype).contiguous(), w1, b1, w2, b2)


@torch.no_grad()
def round_weights_(module: nn.Module, dtype: torch.dtype) -> None:
    """Round, in place, every conv weight and bias under ``module`` to
    ``dtype``'s values; they stay f32 tensors, which the convs then read as
    they are (no per-call cast). For a model built for serving with BN
    folded only: a model that trains keeps unrounded f32 masters. A no-op
    in f32 and f64."""
    if dtype in (torch.float32, torch.float64):
        return
    for m in module.modules():
        if isinstance(m, _ConvParams):
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_(p.to(dtype).float())
            m.held_at = dtype
