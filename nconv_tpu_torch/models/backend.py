"""Device and kernel-path resolution shared by every entry point.

A CUDA tensor goes to the hand-written kernels and a CPU tensor to their
plain PyTorch versions (:func:`on_card`, applied by every kernel wrapper);
nothing else chooses a path. Entry points run on ``cuda`` unless the caller
asks for ``cpu``; without a GPU, asking for ``cuda`` raises.
"""
from __future__ import annotations

import torch

from ..kernels import on_card

__all__ = ["on_card", "resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nconv_tpu_torch runs on CUDA by default and no GPU is visible; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
