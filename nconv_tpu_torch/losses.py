"""Training losses, NHWC as in the JAX package (``nconv_tpu.losses``).

  * sparse-GT masking zeroes the prediction wherever gt == 0, then takes
    plain MSE over all pixels;
  * the gradient loss Sobel-filters the (gt - pred) difference and averages
    the absolute responses of both directions;
  * the combined loss is 0.8 * sqrt(MSE) + 0.2 * gradient;
  * the multi-resolution loss bilinearly resizes every scale to the full
    resolution (align_corners=False) and averages; ``batch_reduce='first'``
    keeps batch element 0 only (the reference's behaviour), ``'mean'`` the
    whole batch.

Under a data-parallel mesh of world size > 1
(:func:`.parallel.mesh.data_parallel`) each loss is the global batch's:
the squared-error and |Sobel| sums go through one differentiable
all-reduce, since ``sqrt(mse)`` does not split into per-rank pieces.
"""
from __future__ import annotations

import math

import torch

from .ops.resize import resize_bilinear
from .ops.sobel import sobel_xy
from .parallel.mesh import active_rank, active_world, all_sum


def _masked(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.where(gt == 0, torch.zeros_like(pred), pred)


def masked_mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """MSE with the prediction zeroed where gt == 0."""
    return ((_masked(pred, gt) - gt) ** 2).mean()


def gradient_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean |Sobel| of the (gt - pred) difference, x + y directions."""
    gx, gy = sobel_xy(gt - pred)
    return gx.abs().mean() + gy.abs().mean()


def depth_loss(pred: torch.Tensor, gt: torch.Tensor, *, use_gradient_loss: bool = True) -> torch.Tensor:
    """The reference's ``calculate_loss``."""
    if active_world() > 1:
        return _global_depth_loss(pred, gt, use_gradient_loss, pred.shape[0] * active_world())
    masked = _masked(pred, gt)
    mse = ((masked - gt) ** 2).mean()
    if not use_gradient_loss:
        return mse
    return 0.8 * torch.sqrt(mse) + 0.2 * gradient_loss(masked, gt)


def _global_depth_loss(pred, gt, use_gradient_loss, rows):
    """:func:`depth_loss` over the ranks of the active mesh, ``rows`` batch
    rows in all: each rank's sums, all-reduced, over the global counts."""
    masked = _masked(pred, gt)
    per_row = math.prod(masked.shape[1:])
    sums = [((masked - gt) ** 2).sum()]
    if use_gradient_loss:
        gx, gy = sobel_xy(gt - masked)
        sums += [gx.abs().sum(), gy.abs().sum()]
    sums = all_sum(torch.stack(sums)) / (rows * per_row)  # sobel_xy keeps the size
    if not use_gradient_loss:
        return sums[0]
    return 0.8 * torch.sqrt(sums[0]) + 0.2 * (sums[1] + sums[2])


def multi_resolution_loss(
    scales: list[torch.Tensor],
    gt: torch.Tensor,
    *,
    use_gradient_loss: bool = True,
    batch_reduce: str = "mean",
) -> torch.Tensor:
    """Each scale's prediction resized to gt's resolution, the per-scale
    losses averaged."""
    h, w = gt.shape[1:3]
    total = 0.0
    for pred in scales:
        up = resize_bilinear(pred.permute(0, 3, 1, 2), (h, w), align_corners=False).permute(0, 2, 3, 1)
        if batch_reduce == "first" and active_world() > 1:  # global element 0 lives on rank 0
            keep = int(active_rank() == 0)
            loss = _global_depth_loss(up[:keep], gt[:keep], use_gradient_loss, 1)
        elif batch_reduce == "first":
            loss = depth_loss(up[0:1], gt[0:1], use_gradient_loss=use_gradient_loss)
        else:
            loss = depth_loss(up, gt, use_gradient_loss=use_gradient_loss)
        total = total + loss
    return total / len(scales)
