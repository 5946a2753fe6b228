"""Device: the share of the profiled slice's wall time in which no device op ran, %."""
from benchmark import trace


def read(traced):
    return trace.idle_share(traced)
