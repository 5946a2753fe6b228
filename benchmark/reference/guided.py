"""Plain reference of the guided network's deployed forward, two streams.

The network (``models/step2.py`` of lllllcf/Realtime-Depth-Estimation-Nconv,
as exported for deployment): the step-1 densifier (:mod:`.step1`) on each
stream's sparse depth; a residual RGB encoder of four stages,
``relu(BN(conv3x3_s(x))) + conv1x1_s(x)``; four fusion stages coarse to
fine, each upsampling ``[depth | fusion]`` of the stage before by a
4x4/s2/p1 transposed conv + BN + ReLU and convolving it with the RGB skip
(conv + BN + ReLU), then fusing an RGB branch and a depth branch (the dense
depth bilinearly downscaled, align_corners=True) through five conv + ReLU
blocks, and adding a 3x3 -> 1 head to the downscaled depth. The output is
the finest depth with the sensor border zeroed (45 rows top and bottom, 20
columns left).

This reference folds every BatchNorm into the conv before it, decodes the
wires (uint8 RGB read as raw 0..255 values; uint16 depth
``trunc(clip(d * 256, 0, 65535)) / 256``), and rounds where the
configuration stores a tensor: ``feature`` is the storage of the feature
convs' inputs, weights, biases and outputs (``"bf16"`` for the mixed
schedule), ``depth`` that of step 1 and every depth tensor (``"f32"``).
Arithmetic is float32, TF32 off. Widths come from the configuration file.
Imports torch and numpy only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import precision, step1

BN_EPS = 1e-5
BORDER_TOP, BORDER_BOTTOM, BORDER_LEFT = 45, 45, 20
DEPTH_SCALE = 256.0


def fold(state: dict) -> dict:
    """The state dict with each ``P.bn.*`` folded into ``P.conv`` (OIHW,
    output axis 0) or ``P.conv_t`` (transposed, output axis 1)."""
    out = dict(state)
    for p in [k[: -len(".bn.running_mean")] for k in state if k.endswith(".bn.running_mean")]:
        bn = {leaf: out.pop(f"{p}.bn.{leaf}").float() for leaf in ("weight", "bias", "running_mean", "running_var")}
        conv = f"{p}.conv_t" if f"{p}.conv_t.weight" in out else f"{p}.conv"
        g = bn["weight"] / torch.sqrt(bn["running_var"] + BN_EPS)
        shape = (1, -1, 1, 1) if conv.endswith("conv_t") else (-1, 1, 1, 1)
        out[f"{conv}.weight"] = out[f"{conv}.weight"].float() * g.view(shape)
        base = out.get(f"{conv}.bias")
        out[f"{conv}.bias"] = bn["bias"] + ((0.0 if base is None else base.float()) - bn["running_mean"]) * g
    return out


def decode_depth(depth: np.ndarray) -> np.ndarray:
    """Metres through the uint16 wire and back, (H, W) float32."""
    wire = np.clip(np.asarray(depth, np.float32) * np.float32(DEPTH_SCALE), 0, 65535).astype(np.uint16)
    return wire.astype(np.float32) / np.float32(DEPTH_SCALE)


class _Net:
    def __init__(self, state, cfg, feature, depth):
        self.s, self.cfg = state, cfg
        self.q, self.qd = precision.STORE[feature], precision.STORE[depth]
        self.depth_store = depth

    def conv(self, name, parts, *, stride=1, relu=True, shortcut=None):
        q = self.q
        x = q(torch.cat([p.float() for p in parts], 1))
        b = self.s.get(f"{name}.bias")
        y = F.conv2d(x, q(self.s[f"{name}.weight"]), None if b is None else q(b), stride, 1)
        if relu:
            y = torch.relu(y)
        if shortcut is not None:
            y = y + F.conv2d(x, q(self.s[shortcut]), stride=stride)
        return q(y)

    def conv_t(self, name, parts):
        q = self.q
        x = q(torch.cat([p.float() for p in parts], 1))
        y = F.conv_transpose2d(x, q(self.s[f"{name}.weight"]), q(self.s[f"{name}.bias"]), stride=2, padding=1)
        return q(torch.relu(y))

    def fusion_block(self, name, rgb, depth):
        rgb_feat = self.conv(f"{name}.rgb_conv.conv", [rgb])
        depth_feat = self.conv(f"{name}.depth_conv.conv", [depth])
        fused = self.conv(f"{name}.fuse_conv1.conv", [rgb_feat, depth_feat])
        return self.conv(f"{name}.fuse_conv3.conv", [self.conv(f"{name}.fuse_conv2.conv", [fused])])

    def downscale(self, dense, factor):
        h, w = dense.shape[-2:]
        if factor == 1:
            return dense
        return self.qd(F.interpolate(dense, size=(h // factor, w // factor), mode="bilinear", align_corners=True))

    def __call__(self, rgb, sparse):
        """rgb (B, 3, H, W) raw values, sparse (B, 1, H, W) decoded metres."""
        cfg = self.cfg
        dense = step1.forward(self.s, sparse, prefix="step1.", store=self.depth_store)
        skips, x = [], rgb
        for i, stride in enumerate(cfg["rgb_encoder_strides"]):
            x = self.conv(f"rgb_encoder{i}.conv", [x], stride=stride, shortcut=f"rgb_encoder{i}.shortcut.weight")
            skips.append(x)
        fusion = depth = None
        for k, scale in enumerate(cfg["fusion_scales"]):
            name, skip = f"fuse{k}", skips[len(skips) - 1 - k]
            if k:
                up = self.conv_t(f"{name}.upcat.upf.conv_t", [depth, fusion])
                skip = self.conv(f"{name}.upcat.conv.conv", [up, skip])
            low = self.downscale(dense, scale)
            fusion = self.fusion_block(f"{name}.fuse", skip, low)
            depth = self.qd(low + self.conv(f"{name}.conv.conv", [fusion], relu=False).float())
        return depth


def export(state: dict, frames, cfg: dict, *, feature="bf16", depth="f32", device="cpu"):
    """The two streams' border-masked depth, each (1, H, W, 1), of one
    request ``frames = (rgb0, depth0, rgb1, depth1)`` (host HWC uint8 RGB,
    HW float metres), given the unfolded ``state`` (BN folded here)."""
    state = fold({k: v.to(device) for k, v in state.items()})
    rgb = torch.stack([torch.from_numpy(np.ascontiguousarray(frames[i])) for i in (0, 2)]).to(device)
    sparse = torch.stack([torch.from_numpy(decode_depth(frames[i])) for i in (1, 3)]).to(device)
    out = _Net(state, cfg, feature, depth)(rgb.permute(0, 3, 1, 2).float(), sparse[:, None])
    h, w = out.shape[-2:]
    mask = torch.ones((h, w), device=device)
    mask[:BORDER_TOP] = 0
    mask[h - BORDER_BOTTOM:] = 0
    mask[:, :BORDER_LEFT] = 0
    out = out * mask
    return out[0:1].permute(0, 2, 3, 1), out[1:2].permute(0, 2, 3, 1)
