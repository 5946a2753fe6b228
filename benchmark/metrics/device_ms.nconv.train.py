"""Step-1 densifier: device ms a training step of K1's forward (`csrc/nconv.cu`)."""
from benchmark import trace

SYMBOLS = ("nct::nc::",)


def read(traced):
    return trace.device_ms(traced, SYMBOLS)
