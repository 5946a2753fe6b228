"""Step-1 training graph: device ms a step of the normalized convs' input cotangents (K2's K x K form, `csrc/conv.cu`)."""
from benchmark import trace

SYMBOLS = ("nct::kxk::",)


def read(traced):
    return trace.device_ms(traced, SYMBOLS)
