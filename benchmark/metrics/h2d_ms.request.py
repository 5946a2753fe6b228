"""Engine layer: p50 ms over the traced slice's requests of `device.h2d`, the device time of the wire's host-to-device copy on the engine's copy stream (CUDA events put on the host clock by the program's tracer, `nconv_tpu_torch.runtime.tracing`); none on the CPU."""
import statistics


def read(traced):
    try:
        from nconv_tpu_torch.runtime import tracing
    except ImportError:  # a program without the tracer
        return None
    ms = [s.ms for s in tracing.collected() if s.name == "device.h2d"]
    return statistics.median(ms) if ms else None
