"""Engine layer: p50 ms over the traced slice's requests of a request's `engine.encode` spans summed (both streams' RGB copy and depth encode into the pinned slot), from the program's tracer (`nconv_tpu_torch.runtime.tracing`, on while the slice is profiled)."""
import statistics


def read(traced):
    try:
        from nconv_tpu_torch.runtime import tracing
    except ImportError:  # a program without the tracer
        return None
    per_frame = {}
    for s in tracing.collected():
        if s.name == "engine.encode":
            per_frame[s.frame] = per_frame.get(s.frame, 0.0) + s.ms
    return statistics.median(per_frame.values()) if per_frame else None
