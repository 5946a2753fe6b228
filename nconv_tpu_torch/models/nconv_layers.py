"""Normalized-convolution layer (step 1 building block)."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.nconv import EPS_DEFAULT, INIT_FNS, POS_FNS, nconv2d_fused, nconv2d_trainable


class NConv2d(nn.Module):
    """Normalized convolution with confidence propagation, stride 1.

    ``weight`` (cout, cin, k, k) holds the raw kernel; ``pos_fn`` makes it
    non-negative at every call. With grad disabled, ``forward`` takes data
    and confidence as tensors or as equal-length lists of parts (a logical
    channel concat) and runs the fused forward, see
    :func:`nconv_tpu_torch.ops.nconv2d_fused`. With grad enabled it takes
    single full-resolution tensors and runs the differentiable form,
    :func:`nconv_tpu_torch.ops.nconv2d_trainable`.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 5,
        padding: int = 2,
        *,
        pos_fn: str = "softplus",
        init_method: str = "p",
        bias_value: float = 0.01,
        eps: float = EPS_DEFAULT,
        generator: torch.Generator | None = None,
        device=None,
    ):
        super().__init__()
        self.padding, self.pos_fn, self.eps = padding, pos_fn, eps
        g = generator or torch.Generator().manual_seed(0)
        shape = (out_channels, in_channels, kernel_size, kernel_size)
        self.weight = nn.Parameter(INIT_FNS[init_method](shape, g).to(device))
        self.bias = nn.Parameter(torch.full((out_channels,), bias_value, device=device))

    def forward(self, data, conf, *, up2=None, crop: int = 0, pool_out: bool = False):
        if torch.is_grad_enabled():
            if isinstance(data, (list, tuple)) or up2 or crop or pool_out:
                raise ValueError("with grad enabled NConv2d takes single tensors; parts, "
                                 "up2, crop and pool_out are forms of the no-grad forward")
            return nconv2d_trainable(data, conf, POS_FNS[self.pos_fn](self.weight),
                                     self.bias, padding=self.padding, eps=self.eps)
        d_parts = list(data) if isinstance(data, (list, tuple)) else [data]
        c_parts = list(conf) if isinstance(conf, (list, tuple)) else [conf]
        return nconv2d_fused(
            d_parts, c_parts, POS_FNS[self.pos_fn](self.weight), self.bias,
            padding=self.padding, up2=up2, crop=crop, pool_out=pool_out,
            eps=self.eps,
        )
