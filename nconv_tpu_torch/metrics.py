"""Depth-completion evaluation metrics, valid-pixel masked, NHWC (the JAX
package's ``nconv_tpu/metrics.py``): the KITTI/NYU RMSE, MAE, iRMSE, iMAE
and delta set. Every metric ignores the pixels where gt == 0 (invalid) and
returns a 0-d tensor.
"""
from __future__ import annotations

import torch


def _valid(gt: torch.Tensor) -> torch.Tensor:
    return (gt > 0).to(gt.dtype)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / mask.sum().clamp_min(1.0)


def _inverse(pred: torch.Tensor, gt: torch.Tensor, eps: float):
    inv_g = torch.where(gt > 0, 1.0 / gt.clamp_min(eps), torch.zeros_like(gt))
    return 1.0 / pred.clamp_min(eps), inv_g


def rmse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_masked_mean((pred - gt) ** 2, _valid(gt)))


def mae(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return _masked_mean((pred - gt).abs(), _valid(gt))


def irmse(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-depth RMSE (1/km on KITTI when depths are in meters)."""
    inv_p, inv_g = _inverse(pred, gt, eps)
    return torch.sqrt(_masked_mean((inv_p - inv_g) ** 2, _valid(gt)))


def imae(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    inv_p, inv_g = _inverse(pred, gt, eps)
    return _masked_mean((inv_p - inv_g).abs(), _valid(gt))


def delta_threshold(pred: torch.Tensor, gt: torch.Tensor, thresh: float = 1.25) -> torch.Tensor:
    """Fraction of valid pixels with max(pred/gt, gt/pred) < thresh."""
    safe_pred = pred.clamp_min(1e-8)
    safe_gt = torch.where(gt > 0, gt, torch.ones_like(gt))
    ratio = torch.maximum(safe_pred / safe_gt, safe_gt / safe_pred)
    return _masked_mean((ratio < thresh).to(gt.dtype), _valid(gt))


def rel_rmse(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Relative RMSE against a reference output (unmasked)."""
    return torch.sqrt(((pred - ref) ** 2).mean()) / (torch.sqrt((ref ** 2).mean()) + 1e-12)


def compute_all(pred: torch.Tensor, gt: torch.Tensor) -> dict[str, torch.Tensor]:
    return {
        "rmse": rmse(pred, gt),
        "mae": mae(pred, gt),
        "irmse": irmse(pred, gt),
        "imae": imae(pred, gt),
        "delta1": delta_threshold(pred, gt, 1.25),
        "delta2": delta_threshold(pred, gt, 1.25 ** 2),
        "delta3": delta_threshold(pred, gt, 1.25 ** 3),
    }
