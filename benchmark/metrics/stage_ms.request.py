"""Engine layer: p50 ms of a request's `StreamingEngine.stage()` (host encode into a pinned slot, host-to-device copy) to its synchronize."""
from benchmark import trace


def read(traced):
    return trace.span_p50(traced, "stage")
