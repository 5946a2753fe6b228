"""Sobel gradients, NHWC as in the JAX package, for the gradient loss and
edge maps.

The reference's two call sites use opposite sign conventions for the x
kernel: the loss (+1..-1 columns) and the VOID edge detection (-1..+1);
both are kept, since only the loss's absolute value is sign-invariant.
Each direction is two separable 3-tap passes per channel
(KX = [1, 2, 1]^T x [1, 0, -1] and KY = [1, 0, -1]^T x [1, 2, 1], as
correlations), the same function as the JAX package's 3x3 depthwise conv.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _tap3(x: torch.Tensor, axis: int, a: float, b: float, c: float) -> torch.Tensor:
    """a*x[i-1] + b*x[i] + c*x[i+1] along ``axis``, zero padded."""
    n = x.shape[axis]
    xp = F.pad(x, [0, 0] * (x.ndim - axis - 1) + [1, 1])
    return a * xp.narrow(axis, 0, n) + b * xp.narrow(axis, 1, n) + c * xp.narrow(axis, 2, n)


def sobel_xy(x: torch.Tensor, *, convention: str = "loss") -> tuple[torch.Tensor, torch.Tensor]:
    """(grad_x, grad_y) of (B, H, W, C), zero padded, same size."""
    sign = 1.0 if convention == "loss" else -1.0
    gx = _tap3(_tap3(x, 2, sign, 0.0, -sign), 1, 1.0, 2.0, 1.0)
    gy = _tap3(_tap3(x, 1, sign, 0.0, -sign), 2, 1.0, 2.0, 1.0)
    return gx, gy


def edge_magnitude(x: torch.Tensor) -> torch.Tensor:
    gx, gy = sobel_xy(x, convention="edge")
    return torch.sqrt(gx * gx + gy * gy)
