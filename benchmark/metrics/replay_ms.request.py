"""Model step: p50 ms of a request's `StreamingEngine.replay()` (copy into the graph's input, one graph replay, output copies) to its synchronize."""
from benchmark import trace


def read(traced):
    return trace.span_p50(traced, "replay")
