"""Where one two-stream request's, or one train step's, time goes on the card.

    python -m nconv_tpu_torch.runtime.profile [--dtype bf16|f32] [--frames N]
                                              [--train [unguided|guided]]
                                              [--stream [--chrome PATH]]

Builds a ``StreamingEngine`` at KITTI 352x1216 with random weights (which
captures the frame as a CUDA graph), and traces ``N`` requests with
``torch.profiler`` (mixed schedule unless ``--dtype f32``): each a host
encode, copy and graph replay; CUPTI reports the kernels of a replay under
their own names. With ``--train``, traces ``N`` train steps instead
(``Trainer.train_step``, adamw, the JAX bench's synthetic batch): step 1 at
batch 4 (``unguided``, the default; f32 only) or step 2 at batch 1 with step
1 frozen (``guided``; f32 unless ``--dtype bf16``, the mixed schedule with
f32 master weights). Prints one JSON object: the
card, wall ms per request (or step), device-busy ms per request and the
busy share of the window, and device ms per request for each kernel name
(the port's kernels and every PyTorch op between them), largest first.

With ``--stream``, the operator's view of :mod:`.tracing`: ``N`` frames
through ``StreamingEngine.run()`` at its defaults with the tracer on
(:func:`stream`). Its object holds the engine's spans in ms a frame, the
counters, the share of dispatches that waited for a staging worker, the
ten longest gaps between device frames with the span the host was in,
and device frames a second, second by second; ``kernels_build_s`` where
the kernels were built; then, over 100 requests of one client, each
span's p50 ms a request (``request_ms_p50``) and each counter a request
(``request_counts``: ``engine.encode_parallel`` is 1 where the frame was
encoded by the parallel call). With ``--chrome PATH`` the
frames also run under ``torch.profiler`` (every thread's ranges) and PATH
gets one chrome trace: the device's events, every thread's engine spans
and the tracer's device intervals.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import time
from contextlib import nullcontext

import numpy as np
import torch

from ..data import bench_batch
from ..models import GuidedDepthNet, NConvUNet
from ..training import GuidedTask, OptimizerConfig, TrainConfig, Trainer, UnguidedTask
from . import tracing
from .streaming import StreamingEngine


def _engine(dtype, h, w, state=None, pos_fn="softplus"):
    """A ``StreamingEngine`` on the card (random weights unless ``state``
    is given) and a synthetic two-stream u8 frame."""
    if state is None:
        state = GuidedDepthNet(device="cuda").state_dict()
    model = GuidedDepthNet(step1_pos_fn=pos_fn, dtype=dtype, device="cuda")
    eng = StreamingEngine(state, height=h, width=w, model=model)
    rng = np.random.default_rng(0)
    rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    d = (rng.random((h, w)) * 80 * (rng.random((h, w)) < 0.05)).astype(np.float32)
    return eng, (rgb, d, rgb, d)


def request(dtype, h, w, state=None, pos_fn="softplus"):
    """A two-stream request of a ``StreamingEngine`` (random weights unless
    ``state`` is given) on a synthetic u8 frame, as a callable."""
    eng, frame = _engine(dtype, h, w, state, pos_fn)
    return lambda: eng(*frame)


def _train_step(kind, dtype, h, w):
    if kind == "guided":
        b, task = 1, GuidedTask(GuidedDepthNet(device="cuda", dtype=dtype))
    elif dtype != torch.float32:
        raise SystemExit("profile: step-1 training has no bf16 mode")
    else:
        b, task = 4, UnguidedTask(NConvUNet(device="cuda"))
    trainer = Trainer(task, TrainConfig(batch_size=b, optimizer=OptimizerConfig("adamw", 1e-3, 1e-7)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in bench_batch(b, h, w).items()}
    return lambda: trainer.train_step(batch)


def trace(run, frames: int) -> dict:
    """``run()`` three times, then ``frames`` times under ``torch.profiler``:
    wall ms a call, device-busy ms a call (the union of the device events'
    intervals: a copy on another stream may overlap a kernel) and its share
    of the wall time, device ms a call and event count a call by kernel
    name (device-side events only: kernels, copies; a GPU user annotation
    spans kernels already counted)."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name, count, spans = {}, {}, []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            per_name[evt.name] = per_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
            count[evt.name] = count.get(evt.name, 0) + 1
            spans.append((evt.time_range.start, evt.time_range.end))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3 / frames
    wall_ms = wall * 1e3 / frames
    order = sorted(per_name, key=lambda k: -per_name[k])
    return {
        "frames": frames,
        "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms if per_name else "not measured",
        "device_busy_share": busy_ms / wall_ms if per_name else "not measured",
        "device_ms_per_request": {k: per_name[k] / 1e3 / frames for k in order},
        "device_events_per_request": {k: count[k] / frames for k in order},
    }


def stream_report(spans, counters: dict, frames: int) -> dict:
    """What the tracer's ``spans`` and ``counters`` say of ``frames``
    frames of ``run()``: ms a frame of each span name, the counters, the
    dispatches that waited (``engine.await_blocked / engine.dispatched``),
    the ten longest gaps between ``device.frame`` intervals, the mean gap
    and the shares of all gap time whose middle lies under a host span
    and under ``engine.await_staged``, and, second by second from the
    first device frame, the device frames that ended in it and the ms a
    frame of each span that began in it."""
    per_name: dict[str, float] = {}
    for s in spans:
        per_name[s.name] = per_name.get(s.name, 0.0) + s.ms
    dispatched = counters.get("engine.dispatched", 0)
    gaps = tracing.idle_gaps(len(spans), spans)
    idle = sum(g.ns for g in gaps)
    device = sorted((s for s in spans if s.name == "device.frame"), key=lambda s: s.start_ns)
    seconds = []
    if device:
        t0 = device[0].start_ns
        for s in spans:
            k = (s.end_ns if s.name == "device.frame" else s.start_ns) - t0
            if k < 0:
                continue
            k //= 1_000_000_000
            while len(seconds) <= k:
                seconds.append({"device_frames": 0, "ms": {}})
            if s.name == "device.frame":
                seconds[k]["device_frames"] += 1
            seconds[k]["ms"][s.name] = seconds[k]["ms"].get(s.name, 0.0) + s.ms
        for sec in seconds:  # ms a frame that ended in the second
            sec["ms"] = {k: v / max(sec["device_frames"], 1) for k, v in sorted(sec["ms"].items())}
    return {
        "span_ms_per_frame": {k: per_name[k] / frames for k in sorted(per_name)},
        "counters": counters,
        "await_blocked_share": counters.get("engine.await_blocked", 0) / dispatched if dispatched else None,
        "idle_gaps": [[g.span, g.ns / 1e6, tracing.threads().get(g.thread, g.thread), list(g.under)]
                      for g in gaps[:10]],
        "frame_gap_ms": idle / 1e6 / (len(device) - 1) if len(device) > 1 else None,
        "idle_named_share": sum(g.ns for g in gaps if g.span) / idle if idle else None,
        "idle_await_staged_share": sum(g.ns for g in gaps if "engine.await_staged" in g.under) / idle
        if idle else None,
        "seconds": seconds,
    }


def request_report(spans) -> dict:
    """p50 ms over the requests (``engine.request`` spans) in ``spans`` of
    each span name summed over a request's frame."""
    requests = {s.frame for s in spans if s.name == "engine.request"}
    per_name: dict[str, dict[int, float]] = {}
    for s in spans:
        if s.frame in requests:
            frames = per_name.setdefault(s.name, {})
            frames[s.frame] = frames.get(s.frame, 0.0) + s.ms
    return {name: statistics.median(v.values()) for name, v in sorted(per_name.items())}


def request_counts(spans, counters: dict) -> dict:
    """Each of ``counters`` over the requests (``engine.request`` spans) in
    ``spans``: the count a request."""
    n = sum(s.name == "engine.request" for s in spans)
    return {name: c / n for name, c in sorted(counters.items())} if n else {}


def _profiler_all_threads():
    """``torch.profiler.profile`` of the device and every thread's ranges."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=acts, experimental_config=config)


def write_chrome(prof, path: str, spans) -> None:
    """``prof``'s chrome trace at ``path``, with the tracer's device
    intervals (which the profiler does not record) put on the trace's clock
    through :func:`tracing.wall_ns`; the host spans are in it already, as
    the profiler's ranges of their threads."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    for s in spans:
        if s.thread is None:
            trace["traceEvents"].append({"ph": "X", "cat": "nconv_tpu_torch", "name": s.name, "pid": "tracer",
                                         "tid": s.name, "ts": (tracing.wall_ns(s.start_ns) - base) / 1e3,
                                         "dur": s.ms * 1e3, "args": {"frame": s.frame}})
    with open(path, "w") as f:
        json.dump(trace, f)


def stream(dtype, h, w, frames: int, chrome: str | None = None) -> dict:
    """``frames`` frames through ``run()`` at its defaults, the tracer on
    from before the engine's construction (``kernels.build`` shows a
    rebuild); with ``chrome`` under ``torch.profiler`` too. Then 100
    requests of one client (``engine(*frame)``, a synchronize each) for
    :func:`request_report`."""
    tracing.clear()
    tracing.enable()
    eng, frame = _engine(dtype, h, w)
    for _ in eng.run(itertools.repeat(frame, 16)):  # the ring's slots and the staging threads
        pass
    torch.cuda.synchronize()
    build = [s.ms / 1e3 for s in tracing.collected() if s.name == "kernels.build"]
    tracing.clear()
    prof = _profiler_all_threads() if chrome else nullcontext()
    with prof:
        t0 = time.perf_counter()
        for _ in eng.run(itertools.repeat(frame, frames)):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, counters = tracing.collected(), tracing.counters()
    out = {"frames": frames, "wall_s": wall, "frames_per_s": frames / wall,
           **({"kernels_build_s": build[0]} if build else {}), **stream_report(spans, counters, frames)}
    if chrome:
        write_chrome(prof, chrome, spans)
        out["chrome"] = chrome
    tracing.clear()
    for _ in range(100):
        eng(*frame)
        torch.cuda.synchronize()
    tracing.disable()
    out["request_ms_p50"] = request_report(tracing.collected())
    out["request_counts"] = request_counts(tracing.collected(), tracing.counters())
    return out


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"),
                    help="compute dtype: bf16 for requests, f32 for train steps by default")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--train", nargs="?", const="unguided", choices=("unguided", "guided"),
                    help="trace train steps of step 1 (default) or of step 2")
    ap.add_argument("--stream", action="store_true", help="the engine's spans over N frames of run()")
    ap.add_argument("--chrome", metavar="PATH", help="with --stream: write a chrome trace of the frames")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    if args.chrome and not args.stream or args.stream and args.train:
        raise SystemExit("profile: --chrome goes with --stream, and --stream not with --train")
    h, w = 352, 1216
    name = args.dtype or ("f32" if args.train else "bf16")
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    if args.stream:
        out = {"card": card(), "what": "stream", "dtype": name, "hw": [h, w],
               **stream(dtype, h, w, args.frames, args.chrome)}
        print(json.dumps(out))
        return out
    run = _train_step(args.train, dtype, h, w) if args.train else request(dtype, h, w)
    what = f"{args.train}_train_step" if args.train else "request"
    out = {"card": card(), "what": what, "dtype": name, "hw": [h, w], **trace(run, args.frames)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
