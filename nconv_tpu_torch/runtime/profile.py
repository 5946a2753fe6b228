"""Where one two-stream request's, or one train step's, time goes on the card.

    python -m nconv_tpu_torch.runtime.profile [--dtype bf16|f32] [--frames N]
                                              [--train [unguided|guided]]

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
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..data import bench_batch
from ..models import GuidedDepthNet, NConvUNet
from ..training import GuidedTask, OptimizerConfig, TrainConfig, Trainer, UnguidedTask
from .streaming import StreamingEngine


def request(dtype, h, w, state=None, pos_fn="softplus"):
    """A two-stream request of a ``StreamingEngine`` (random weights unless
    ``state`` is given) on a synthetic u8 frame, as a callable."""
    if state is None:
        state = GuidedDepthNet(device="cuda").state_dict()
    model = GuidedDepthNet(step1_pos_fn=pos_fn, dtype=dtype, device="cuda")
    eng = StreamingEngine(state, height=h, width=w, model=model)
    rng = np.random.default_rng(0)
    rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    d = (rng.random((h, w)) * 80 * (rng.random((h, w)) < 0.05)).astype(np.float32)
    return lambda: eng(rgb, d, rgb, d)


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    h, w = 352, 1216
    name = args.dtype or ("f32" if args.train else "bf16")
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    run = _train_step(args.train, dtype, h, w) if args.train else request(dtype, h, w)
    what = f"{args.train}_train_step" if args.train else "request"
    out = {"card": card(), "what": what, "dtype": name, "hw": [h, w], **trace(run, args.frames)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
