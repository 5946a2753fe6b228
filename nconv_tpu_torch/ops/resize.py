"""Resizing with torch's conventions, NCHW, from explicit index and weight
tables (computed in float32, as torch's own kernels compute them), each
built once per (sizes, device, dtype) and kept on the device
(:data:`.tables.TABLES`).

Spatial sizes are read as Python ints: the ONNX tracer hands a tensor's
sizes over as tensors, and H and W are fixed in a traced graph (only the
batch axis is dynamic)."""
from __future__ import annotations

import numpy as np
import torch

from .tables import TABLES


def _nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    # torch nearest: src = floor(dst * in / out)
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of the last two axes to ``size=(H, W)``."""
    h_out, w_out = map(int, size)
    h_in, w_in = map(int, x.shape[-2:])
    if (h_out, w_out) == (h_in, w_in):
        return x
    return x.index_select(-2, _nearest_table(h_out, h_in, x.device)).index_select(
        -1, _nearest_table(w_out, w_in, x.device))


def _nearest_table(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    return TABLES.get(("nearest", out_size, in_size, device),
                      lambda: torch.as_tensor(_nearest_indices(out_size, in_size), device=device))


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


def _linear_table(out_size: int, in_size: int, align_corners: bool, device: torch.device,
                  dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, frac) on ``device``, frac in ``dtype``."""
    def build():
        weights = _linear_weights_align_true if align_corners else _linear_weights_align_false
        lo, hi, frac = weights(out_size, in_size)
        return (torch.as_tensor(lo, device=device), torch.as_tensor(hi, device=device),
                torch.as_tensor(frac, device=device).to(dtype))

    return TABLES.get(("linear", out_size, in_size, align_corners, device, dtype), build)


def _lerp_axis(x: torch.Tensor, axis: int, out_size: int, align_corners: bool) -> torch.Tensor:
    lo, hi, frac = _linear_table(out_size, int(x.shape[axis]), align_corners, x.device, x.dtype)
    shape = [1] * x.ndim
    shape[axis] = -1
    f = frac.view(shape)
    return x.index_select(axis, lo) * (1 - f) + x.index_select(axis, hi) * f


def resize_bilinear(
    x: torch.Tensor, size: tuple[int, int], *, align_corners: bool
) -> torch.Tensor:
    """Bilinear resize of the last two axes, rows first, then columns."""
    h_out, w_out = map(int, size)
    h_in, w_in = map(int, x.shape[-2:])
    if (h_out, w_out) == (h_in, w_in):
        return x
    if h_out != h_in:
        x = _lerp_axis(x, x.ndim - 2, h_out, align_corners)
    if w_out != w_in:
        x = _lerp_axis(x, x.ndim - 1, w_out, align_corners)
    return x


def torch_scaled_size(in_size: int, scale: float) -> int:
    """Output size torch computes for ``F.interpolate(scale_factor=scale)``."""
    return int(np.floor(in_size * scale))


def downscale_bilinear(x: torch.Tensor, factor: int, *, align_corners: bool = True):
    """``F.interpolate(x, scale_factor=1/factor, mode='bilinear')`` parity."""
    h, w = map(int, x.shape[-2:])
    size = (torch_scaled_size(h, 1.0 / factor), torch_scaled_size(w, 1.0 / factor))
    return resize_bilinear(x, size, align_corners=align_corners)
