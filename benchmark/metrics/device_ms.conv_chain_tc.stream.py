"""RGB encoder and fusion decoder: device ms a two-stream frame of the chained convs of the fusion blocks (`csrc/conv_chain_tc.cu`)."""
from benchmark import trace

SYMBOLS = ("nct::chain_tc::",)


def read(traced):
    return trace.device_ms(traced, SYMBOLS)
