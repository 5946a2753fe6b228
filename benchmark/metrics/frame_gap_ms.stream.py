"""Engine layer: the device's mean idle ms between consecutive frames of the traced slice: the sum over `device.frame` intervals i of max(0, start of i + 1 - end of i) over frames - 1 (CUDA events put on the host clock by the program's tracer, `nconv_tpu_torch.runtime.tracing`); none on the CPU."""


def read(traced):
    try:
        from nconv_tpu_torch.runtime import tracing
    except ImportError:  # a program without the tracer
        return None
    frames = sorted((s.start_ns, s.end_ns) for s in tracing.collected() if s.name == "device.frame")
    if len(frames) < 2:
        return None
    idle = sum(max(0, b[0] - a[1]) for a, b in zip(frames, frames[1:]))
    return idle / 1e6 / (len(frames) - 1)
