"""Trainer: device ms a step of everything not from `csrc/` (PyTorch's own ops of the loss, pools, resizes, concats and AdamW; copies)."""
from benchmark import trace

SYMBOLS = ("nct::",)


def read(traced):
    return trace.device_ms_outside(traced, SYMBOLS)
