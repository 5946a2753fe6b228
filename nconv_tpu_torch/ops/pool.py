"""Pooling of (signal, confidence) pairs, NCHW."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_pair(
    x: torch.Tensor, c: torch.Tensor, window: int = 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent ``window``x``window`` max-pools (floor mode), one of
    the signal and one of the confidence — not confidence-argmax pooling."""
    return F.max_pool2d(x, window), F.max_pool2d(c, window)
