"""Unguided sparse-to-dense depth network (step 1): a 3-level
confidence-carrying encoder-decoder of normalized convolutions.

Geometry: nconv6 runs 3x3 with pad 0 (shrinks H, W by 2) and nconv7 is 1x1
with pad 2 (grows by 4), so the output is cropped ``[1:H+1, 1:W+1]``.

With grad disabled (serving) the crop is folded into nconv7's output
geometry, the decoder's ``[skip | upsampled]`` concats and 2x nearest
upsamples enter the fused nconv op as separate parts, and the three encoder
pools are emitted by the nconvs before them, so none of them exists as a
tensor of its own. With grad enabled (training) the forward is the JAX
package's training graph: materialized pools, nearest resizes and concats,
whose backward autograd carries, between the nine differentiable nconvs,
then nconv7 uncropped and the crop.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels import widen
from ..ops.pool import max_pool_pair
from ..ops.resize import resize_nearest
from .backend import resolve_device
from .nconv_layers import NConv2d

CONF_THRESHOLD = 0.01  # confidence seed: c0 = (depth > 0.01)


class NConvUNet(nn.Module):
    """Input ``(B, H, W, 1)`` sparse depth (H, W divisible by 8); output
    ``(dense_depth, confidence)``, both ``(B, H, W, 1)`` float32."""

    def __init__(self, num_channels: int = 8, pos_fn: str = "softplus", *,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        c = num_channels

        def mk(cin, cout, k, pad, init="p"):
            return NConv2d(cin, cout, k, pad, pos_fn=pos_fn, init_method=init,
                           generator=g, device=dev)

        self.nconv1 = mk(1, c, 5, 2)
        self.nconv2 = mk(c, c, 5, 2)
        self.nconv_down1 = mk(c, c, 5, 2)
        self.nconv_down2 = mk(c, c, 5, 2)
        self.nconv_down3 = mk(c, c, 5, 2)
        self.nconv4 = mk(2 * c, c, 3, 1)
        self.nconv5 = mk(2 * c, c, 3, 1)
        self.nconv6 = mk(2 * c, c, 3, 0)
        self.nconv7 = mk(c, 1, 1, 2, init="k")

    def forward(self, sparse: torch.Tensor):
        b, h, w, _ = sparse.shape
        if h % 8 or w % 8:
            raise ValueError(f"NConvUNet needs H and W divisible by 8; got {h}x{w}")
        x0 = widen(sparse).reshape(b, 1, h, w)
        c0 = (x0 > CONF_THRESHOLD).to(x0.dtype)
        graph = self._training_graph if torch.is_grad_enabled() else self._fused_graph
        xo, co = graph(x0, c0)
        return xo.reshape(b, h, w, 1), co.reshape(b, h, w, 1)

    def _fused_graph(self, x0, c0):
        x1, c1 = self.nconv1(x0, c0)
        x1, c1, x1d, c1d = self.nconv2(x1, c1, pool_out=True)
        x2, c2, x2d, c2d = self.nconv_down1(x1d, c1d, pool_out=True)
        x3, c3, x3d, c3d = self.nconv_down2(x2d, c2d, pool_out=True)
        x4, c4 = self.nconv_down3(x3d, c3d)

        x34, c34 = self.nconv4([x3, x4], [c3, c4], up2=[False, True])
        x23, c23 = self.nconv5([x2, x34], [c2, c34], up2=[False, True])
        xo, co = self.nconv6([x23, x1], [c23, c1], up2=[True, False])  # (H-2, W-2)
        return self.nconv7(xo, co, crop=1)  # (H+2, W+2) cropped to (H, W)

    def _training_graph(self, x0, c0):
        h, w = x0.shape[2:]

        def cat_up(lo, skip, skip_first=True):
            up = resize_nearest(lo, tuple(skip.shape[2:]))
            return torch.cat([skip, up] if skip_first else [up, skip], 1)

        x1, c1 = self.nconv1(x0, c0)
        x1, c1 = self.nconv2(x1, c1)
        x2, c2 = self.nconv_down1(*max_pool_pair(x1, c1))
        x3, c3 = self.nconv_down2(*max_pool_pair(x2, c2))
        x4, c4 = self.nconv_down3(*max_pool_pair(x3, c3))

        x34, c34 = self.nconv4(cat_up(x4, x3), cat_up(c4, c3))
        x23, c23 = self.nconv5(cat_up(x34, x2), cat_up(c34, c2))
        xo, co = self.nconv6(cat_up(x23, x1, False), cat_up(c23, c1, False))  # (H-2, W-2)
        xo, co = self.nconv7(xo, co)  # (H+2, W+2)
        return xo[:, :, 1:h + 1, 1:w + 1], co[:, :, 1:h + 1, 1:w + 1]


class Step1Unguided(nn.Module):
    """Step 1 over any number of sparse-depth streams: the streams are
    concatenated on the batch axis through one shared :class:`NConvUNet`
    (``d_net``), whose dense depth comes back batch-stacked (stream i in
    rows ``[i * B, (i + 1) * B)``)."""

    def __init__(self, num_channels: int = 8, pos_fn: str = "softplus", *,
                 device=None, seed: int = 0):
        super().__init__()
        self.d_net = NConvUNet(num_channels, pos_fn, device=device, seed=seed)

    def forward(self, *depths: torch.Tensor) -> torch.Tensor:
        out, _ = self.d_net(depths[0] if len(depths) == 1 else torch.cat(depths, 0))
        return out
