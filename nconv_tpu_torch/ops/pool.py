"""Pooling of (signal, confidence) pairs, NCHW."""
from __future__ import annotations

import torch


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/s2 max-pool (floor mode) as split maxes, rows then columns.

    The values are ``F.max_pool2d``'s; the gradient is the JAX training
    graph's (``jnp.maximum`` over strided halves): a tie splits the
    cotangent in half at each level, where ``F.max_pool2d`` gives all of it
    to one element. Ties are common here: confidence is exactly 0 far from
    any sample."""
    h2, w2 = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h2, :w2]
    y = torch.maximum(x[..., 0::2, :], x[..., 1::2, :])
    return torch.maximum(y[..., 0::2], y[..., 1::2])


def max_pool_pair(x: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent 2x2 max-pools, one of the signal and one of the
    confidence — not confidence-argmax pooling."""
    return max_pool2x2(x), max_pool2x2(c)
