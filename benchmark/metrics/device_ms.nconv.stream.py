"""Step-1 densifier: device ms a two-stream frame of K1 (`csrc/nconv.cu`)."""
from benchmark import trace

SYMBOLS = ("nct::nc::",)


def read(traced):
    return trace.device_ms(traced, SYMBOLS)
