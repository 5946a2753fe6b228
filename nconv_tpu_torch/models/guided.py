"""RGB-guided depth refinement network (step 2): the step-1 densifier feeds
a 4-stage coarse-to-fine residual-refinement decoder guided by an RGB
encoder pyramid. Two input streams are batch-concatenated through shared
weights.

Precision: ``dtype`` is the feature-conv compute dtype (bf16 for the mixed
schedule). Parameters stay f32 masters, and each conv reads a copy cast to
``dtype`` (see :mod:`.layers`); only a model built with ``fold_bn=True``
(for serving) rounds its feature convs' weights once, at construction and
whenever a state dict is loaded. Step 1, every depth tensor and the BN
statistics stay f32, and the per-scale residual adds promote the head's
output back to f32.

Training (step 2, f32 or the mixed schedule): with grad enabled the convs
run through their autograd Functions and BN follows ``train()`` /
``eval()``; step 1 is frozen and always runs its fused serving graph under
``torch.no_grad()``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.resize import downscale_bilinear
from .backend import resolve_device
from .layers import (
    Basic2d,
    Basic2dTrans,
    Conv3x3Head,
    ConvBlock,
    RGBEncoder,
    conv_chain,
    round_weights_,
)
from .unguided import NConvUNet

# export-mode sensor border
BORDER_TOP = 45
BORDER_BOTTOM = 45
BORDER_LEFT = 20


def border_mask(h: int, w: int, *, device=None, dtype=torch.float32) -> torch.Tensor:
    """(1, 1, h, w) 0/1 mask zeroing the sensor border of the final depth."""
    m = np.ones((1, 1, h, w), np.float32)
    m[:, :, :BORDER_TOP] = 0.0
    m[:, :, h - BORDER_BOTTOM :] = 0.0
    m[:, :, :, :BORDER_LEFT] = 0.0
    return torch.as_tensor(m, device=device, dtype=dtype)


class UpCat(nn.Module):
    """Transpose-conv 2x upsample of ``[depth | fusion]`` (this swapped
    order is the reference checkpoints' layout), then a conv over
    ``[upsampled | rgb_skip]``."""

    def __init__(self, features, prev_channels, *, fold_bn, generator, device):
        super().__init__()
        kw = dict(fold_bn=fold_bn, generator=generator, device=device)
        self.upf = Basic2dTrans(1 + prev_channels, features, **kw)
        self.conv = Basic2d(2 * features, features, **kw)

    def forward(self, rgb_skip, fusion, depth, *, dtype):
        fout = self.upf([depth, fusion], dtype=dtype)
        return self.conv([fout, rgb_skip], dtype=dtype)


class NewFusionBlock(nn.Module):
    """RGB-branch conv and depth-branch conv, their concat, then three
    ConvBlocks; without grad the last two run as one chained kernel."""

    def __init__(self, rgb_channels, features, *, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.rgb_conv = ConvBlock(rgb_channels, rgb_channels, **kw)
        self.depth_conv = ConvBlock(1, rgb_channels, **kw)
        self.fuse_conv1 = ConvBlock(2 * rgb_channels, rgb_channels, **kw)
        self.fuse_conv2 = ConvBlock(rgb_channels, features, **kw)
        self.fuse_conv3 = ConvBlock(features, features, **kw)

    def forward(self, rgb, depth, *, dtype):
        rgb_feat = self.rgb_conv(rgb, dtype=dtype)
        depth_feat = self.depth_conv(depth, dtype=dtype)
        fused = self.fuse_conv1([rgb_feat, depth_feat], dtype=dtype)
        if torch.is_grad_enabled():  # K4 has no backward
            return self.fuse_conv3(self.fuse_conv2(fused, dtype=dtype), dtype=dtype)
        return conv_chain(fused, self.fuse_conv2, self.fuse_conv3, dtype=dtype)


class FusionResolution0(nn.Module):
    """Coarsest fusion stage."""

    def __init__(self, features, downsample_factor=8, *, generator, device):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.fuse = NewFusionBlock(features, features, generator=generator, device=device)
        self.conv = Conv3x3Head(features, generator=generator, device=device)

    def forward(self, rgb, dense, *, dtype):
        depth = downscale_bilinear(dense, self.downsample_factor)
        fout = self.fuse(rgb, depth, dtype=dtype)
        return fout, depth + self.conv(fout, dtype=dtype)


class FusionResolutionBlock(nn.Module):
    """Per-scale refinement stage: UpCat, downscaled dense depth, fusion,
    residual head."""

    def __init__(self, in_channels, features, downsample_factor, prev_channels,
                 *, fold_bn, generator, device):
        super().__init__()
        self.downsample_factor = downsample_factor
        kw = dict(generator=generator, device=device)
        self.upcat = UpCat(in_channels, prev_channels, fold_bn=fold_bn, **kw)
        self.fuse = NewFusionBlock(in_channels, features, **kw)
        self.conv = Conv3x3Head(features, **kw)

    def forward(self, rgb, dense, prev_fusion, prev_depth, *, dtype):
        fout = self.upcat(rgb, prev_fusion, prev_depth, dtype=dtype)
        depth = downscale_bilinear(dense, self.downsample_factor)
        fout = self.fuse(fout, depth, dtype=dtype)
        return fout, depth + self.conv(fout, dtype=dtype)


class GuidedDepthNet(nn.Module):
    """The two-stream guided network.

    ``forward(rgb0, depth0, rgb1, depth1)`` returns ``(scales_stream0,
    scales_stream1)``, each the list of 4 depths coarse -> fine, NHWC
    ``(B, h, w, 1)``; with ``rgb1 = depth1 = None`` it runs one stream and
    returns ``(scales, None)``. :meth:`export` is the deployment form
    (final scale, border-masked). Inputs are NHWC: rgb ``(B, H, W, 3)``
    (uint8 frames are decoded inside the first conv), depth ``(B, H, W, 1)``.
    With grad enabled ``forward`` is differentiable in every parameter but
    step 1's (see the module docstring).
    """

    def __init__(
        self,
        *,
        step1_pos_fn: str = "softplus",
        dtype: torch.dtype = torch.float32,
        fold_bn: bool = False,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        self.config = dict(step1_pos_fn=step1_pos_fn, dtype=dtype, fold_bn=fold_bn, seed=seed)
        dev = resolve_device(device)
        self.dtype, self.fold_bn = dtype, fold_bn
        self.step1 = NConvUNet(pos_fn=step1_pos_fn, device=dev, seed=seed)
        g = torch.Generator().manual_seed(seed + 1)
        kw = dict(generator=g, device=dev)
        # encoder: 3->32 s1, 32->64 s2, 64->64 s2, 64->64 s2
        self.rgb_encoder0 = RGBEncoder(3, 32, 1, fold_bn=fold_bn, **kw)
        self.rgb_encoder1 = RGBEncoder(32, 64, 2, fold_bn=fold_bn, **kw)
        self.rgb_encoder2 = RGBEncoder(64, 64, 2, fold_bn=fold_bn, **kw)
        self.rgb_encoder3 = RGBEncoder(64, 64, 2, fold_bn=fold_bn, **kw)
        self.fuse0 = FusionResolution0(64, 8, **kw)
        self.fuse1 = FusionResolutionBlock(64, 64, 4, 64, fold_bn=fold_bn, **kw)
        self.fuse2 = FusionResolutionBlock(64, 32, 2, 64, fold_bn=fold_bn, **kw)
        self.fuse3 = FusionResolutionBlock(32, 32, 1, 32, fold_bn=fold_bn, **kw)
        if fold_bn:  # step 1 holds NConv2d weights only, left f32
            round_weights_(self, dtype)
            self.register_load_state_dict_post_hook(lambda m, _keys: round_weights_(m, m.dtype))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.step1.nconv1.weight.device

    def folded(self) -> "GuidedDepthNet":
        """The same configuration built with BN folded (no weights copied)."""
        return GuidedDepthNet(**{**self.config, "fold_bn": True}, device=self.device)

    def _backbone(self, rgb0, depth0, rgb1, depth1):
        if depth1 is None:
            rgb, depth = rgb0, depth0
        else:
            rgb, depth = torch.cat([rgb0, rgb1]), torch.cat([depth0, depth1])
        b, h, w, _ = depth.shape
        with torch.no_grad():  # step 1 is frozen: its fused serving graph
            dense, _ = self.step1(depth)
        dense = dense.reshape(b, 1, h, w)
        dt = self.dtype
        x = rgb.permute(0, 3, 1, 2)  # NCHW view; the conv reads it by strides
        r0 = self.rgb_encoder0(x, dtype=dt)   # H
        r1 = self.rgb_encoder1(r0, dtype=dt)  # H/2
        r2 = self.rgb_encoder2(r1, dtype=dt)  # H/4
        r3 = self.rgb_encoder3(r2, dtype=dt)  # H/8
        f0, d0 = self.fuse0(r3, dense, dtype=dt)
        f1, d1 = self.fuse1(r2, dense, f0, d0, dtype=dt)
        f2, d2 = self.fuse2(r1, dense, f1, d1, dtype=dt)
        _, d3 = self.fuse3(r0, dense, f2, d2, dtype=dt)
        return d0, d1, d2, d3

    def forward(self, rgb0, depth0, rgb1=None, depth1=None):
        b = rgb0.shape[0]
        nhwc = [d.permute(0, 2, 3, 1) for d in self._backbone(rgb0, depth0, rgb1, depth1)]
        if depth1 is None:
            return nhwc, None
        return [d[:b] for d in nhwc], [d[b:] for d in nhwc]

    @torch.no_grad()
    def export(self, rgb0, depth0, rgb1, depth1):
        """Deployment forward: final-scale depth per stream, border-masked."""
        b = rgb0.shape[0]
        d3 = self._backbone(rgb0, depth0, rgb1, depth1)[-1]
        d3 = d3 * border_mask(d3.shape[2], d3.shape[3], device=d3.device, dtype=d3.dtype)
        out = d3.permute(0, 2, 3, 1)
        return out[:b], out[b:]
