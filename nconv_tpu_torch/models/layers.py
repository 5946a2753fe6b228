"""Building blocks of the guided network, eval forms (NCHW).

Every conv takes its input as a list of parts (a logical channel concat
that is never materialized) and runs in a compute ``dtype``: parts are
rounded to it, arithmetic is f32, the output is stored in it. Weights are
used as they are held: :class:`~.guided.GuidedDepthNet` rounds them to its
compute dtype once, when it loads them (:func:`round_weights_`).
Blocks built with ``fold_bn=True`` hold BatchNorm already folded into the
conv (see :mod:`.fold`) and run as one fused kernel each; unfolded blocks
run conv, :class:`_ChannelBN` and ReLU in turn.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.convops import conv3x3, conv3x3_chain2, conv_transpose4x4s2


def _parts(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to(parts, dtype):
    # uint8 frames enter the first conv as they are and are decoded on load
    return [p if p.dtype == torch.uint8 else p.to(dtype) for p in parts]


def _uniform(shape, bound, generator, device):
    return nn.Parameter(((torch.rand(shape, generator=generator) * 2 - 1) * bound).to(device))


class Conv(nn.Module):
    """Conv weights with torch's default init: U(+-1/sqrt(fan_in)) for the
    kernel (cout, cin, k, k) and the bias."""

    def __init__(self, cin, cout, kernel_size=3, *, bias=True, generator, device):
        super().__init__()
        bound = 1.0 / math.sqrt(cin * kernel_size * kernel_size)
        self.weight = _uniform((cout, cin, kernel_size, kernel_size), bound, generator, device)
        self.bias = _uniform((cout,), bound, generator, device) if bias else None

    def forward(self, x, *, dtype, stride=1, relu=False, shortcut=None):
        """3x3 pad-1 conv of ``x`` (a tensor or a list of parts)."""
        return conv3x3(
            _to(_parts(x), dtype), self.weight, self.bias, stride=stride,
            relu=relu, shortcut=shortcut, out_dtype=dtype,
        )


class ConvTranspose(nn.Module):
    """4x4/s2/p1 transpose-conv weights (cin, cout, 4, 4), torch default init
    with fan_in = 16 * cin."""

    def __init__(self, cin, cout, *, bias=True, generator, device):
        super().__init__()
        bound = 1.0 / math.sqrt(16 * cin)
        self.weight = _uniform((cin, cout, 4, 4), bound, generator, device)
        self.bias = _uniform((cout,), bound, generator, device) if bias else None

    def forward(self, x, *, dtype, relu):
        return conv_transpose4x4s2(_to(_parts(x), dtype), self.weight, self.bias, relu=relu)


class _ChannelBN(nn.Module):
    """Eval-mode BatchNorm over axis 1 with running statistics: the
    per-channel ``rsqrt(var + eps) * weight`` is formed in f32, then the
    elementwise ``(x - mean) * mul + bias`` runs in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, *, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x):
        dt, shape = x.dtype, (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean.to(dt).view(shape)) * mul.to(dt).view(shape) + self.bias.to(dt).view(shape)


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


def _embed_center(k1x1: torch.Tensor) -> torch.Tensor:
    """A 1x1 kernel as the centre tap of a 3x3 pad-1 kernel (same stride,
    same output grid)."""
    k = k1x1.new_zeros(k1x1.shape[:2] + (3, 3))
    k[:, :, 1, 1] = k1x1[:, :, 0, 0]
    return k


class RGBEncoder(nn.Module):
    """Residual encoder stage ``relu(BN(conv3x3_s(x))) + conv1x1_s(x)``.
    Folded, the whole block is one kernel launch with the shortcut in the
    epilogue."""

    def __init__(self, cin, cout, stride, *, fold_bn=False, generator, device):
        super().__init__()
        self.stride, self.fold_bn = stride, fold_bn
        self.conv = Conv(cin, cout, generator=generator, device=device)
        self.bn = None if fold_bn else _ChannelBN(cout, device=device)
        self.shortcut = Conv(cin, cout, 1, bias=False, generator=generator, device=device)

    def forward(self, x, *, dtype):
        sc = self.shortcut.weight
        if self.fold_bn:
            return self.conv(x, dtype=dtype, stride=self.stride, relu=True, shortcut=sc)
        out = torch.relu(self.bn(self.conv(x, dtype=dtype, stride=self.stride)))
        short = conv3x3(_to(_parts(x), dtype), _embed_center(sc), None,
                        stride=self.stride, out_dtype=dtype)
        return out + short


class Conv3x3Head(nn.Module):
    """3x3 -> 1 channel, no bias: the per-scale residual-depth head."""

    def __init__(self, cin, *, generator, device):
        super().__init__()
        self.conv = Conv(cin, 1, bias=False, generator=generator, device=device)

    def forward(self, x, *, dtype):
        return self.conv(x, dtype=dtype)


def conv_chain(x, first: ConvBlock, second: ConvBlock, *, dtype):
    """Two ConvBlocks as one kernel launch (intermediate kept on chip)."""
    c1, c2 = first.conv, second.conv
    return conv3x3_chain2(x.to(dtype).contiguous(), c1.weight, c1.bias, c2.weight, c2.bias)


@torch.no_grad()
def round_weights_(module: nn.Module, dtype: torch.dtype) -> None:
    """Round, in place, every :class:`Conv` and :class:`ConvTranspose`
    weight and bias under ``module`` to ``dtype``'s values; they stay f32
    tensors, which the convs read as they are."""
    if dtype == torch.float32:
        return
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            for p in (m.weight, m.bias):
                if p is not None:
                    p.copy_(p.to(dtype).float())
