"""RGB encoder and fusion decoder: device ms a two-stream frame of the tensor-core conv and transposed conv (`csrc/conv_tc.cu`)."""
from benchmark import trace

SYMBOLS = ("nct::tc::",)


def read(traced):
    return trace.device_ms(traced, SYMBOLS)
