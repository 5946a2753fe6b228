"""Resizing with torch's conventions, NCHW, from explicit index and weight
tables (computed in float32, as torch's own kernels compute them)."""
from __future__ import annotations

import numpy as np
import torch


def _nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    # torch nearest: src = floor(dst * in / out)
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of the last two axes to ``size=(H, W)``."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2:]
    if (h_out, w_out) == (h_in, w_in):
        return x
    hi = torch.as_tensor(_nearest_indices(h_out, h_in), device=x.device)
    wi = torch.as_tensor(_nearest_indices(w_out, w_in), device=x.device)
    return x.index_select(-2, hi).index_select(-1, wi)


def _linear_weights_align_true(out_size: int, in_size: int):
    # align_corners=True: src = i * (in-1)/(out-1), in float32
    if out_size == 1:
        src = np.zeros((1,), np.float32)
    else:
        ratio = np.float32(in_size - 1) / np.float32(out_size - 1)
        src = (np.arange(out_size, dtype=np.float32) * ratio).astype(np.float32)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


def _linear_weights_align_false(out_size: int, in_size: int):
    # align_corners=False: src = (i + 0.5) * in/out - 0.5, clamped, in float32
    ratio = np.float32(in_size) / np.float32(out_size)
    src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * ratio - np.float32(0.5)
    src = np.clip(src, 0.0, in_size - 1).astype(np.float32)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (src - lo).astype(np.float32)
    return lo, hi, frac


def _lerp_axis(x: torch.Tensor, axis: int, lo, hi, frac) -> torch.Tensor:
    dev = x.device
    a = x.index_select(axis, torch.as_tensor(lo, device=dev))
    b = x.index_select(axis, torch.as_tensor(hi, device=dev))
    shape = [1] * x.ndim
    shape[axis] = -1
    f = torch.as_tensor(frac, device=dev).to(x.dtype).view(shape)
    return a * (1 - f) + b * f


def resize_bilinear(
    x: torch.Tensor, size: tuple[int, int], *, align_corners: bool
) -> torch.Tensor:
    """Bilinear resize of the last two axes, rows first, then columns."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2:]
    if (h_out, w_out) == (h_in, w_in):
        return x
    weights = _linear_weights_align_true if align_corners else _linear_weights_align_false
    if h_out != h_in:
        x = _lerp_axis(x, x.ndim - 2, *weights(h_out, h_in))
    if w_out != w_in:
        x = _lerp_axis(x, x.ndim - 1, *weights(w_out, w_in))
    return x


def torch_scaled_size(in_size: int, scale: float) -> int:
    """Output size torch computes for ``F.interpolate(scale_factor=scale)``."""
    return int(np.floor(in_size * scale))


def downscale_bilinear(x: torch.Tensor, factor: int, *, align_corners: bool = True):
    """``F.interpolate(x, scale_factor=1/factor, mode='bilinear')`` parity."""
    h, w = x.shape[-2:]
    size = (torch_scaled_size(h, 1.0 / factor), torch_scaled_size(w, 1.0 / factor))
    return resize_bilinear(x, size, align_corners=align_corners)
