"""Engine layer: ms a dispatched frame that `run()`'s dispatcher spent waiting on the staging workers (`engine.await_staged` summed over the traced slice over the counter `engine.dispatched`), from the program's tracer (`nconv_tpu_torch.runtime.tracing`)."""


def read(traced):
    try:
        from nconv_tpu_torch.runtime import tracing
    except ImportError:  # a program without the tracer
        return None
    dispatched = tracing.counters().get("engine.dispatched", 0)
    waits = [s.ms for s in tracing.collected() if s.name == "engine.await_staged"]
    return sum(waits) / dispatched if dispatched and waits else None
