"""Step-1 training graph: device ms a step of the normalized convs' weight cotangents (K5, `csrc/filtergrad.cu`)."""
from benchmark import trace

SYMBOLS = ("nct::fg::",)


def read(traced):
    return trace.device_ms(traced, SYMBOLS)
