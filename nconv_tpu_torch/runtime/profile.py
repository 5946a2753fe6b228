"""Where one two-stream request's, or one train step's, time goes on the card.

    python -m nconv_tpu_torch.runtime.profile [--dtype bf16|f32] [--frames N] [--train]

Builds a ``StreamingEngine`` at KITTI 352x1216 with random weights, warms
it up, and traces ``N`` requests with ``torch.profiler``; with ``--train``,
traces ``N`` step-1 train steps instead (``Trainer.train_step``, batch 4,
adamw, the JAX bench's synthetic batch, f32). Prints one JSON object: the
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
from ..training import OptimizerConfig, TrainConfig, Trainer, UnguidedTask
from .streaming import StreamingEngine


def _request(dtype, h, w):
    state = GuidedDepthNet(device="cuda").state_dict()
    eng = StreamingEngine(state, height=h, width=w, compute_dtype=dtype)
    rng = np.random.default_rng(0)
    rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    d = (rng.random((h, w)) * 80 * (rng.random((h, w)) < 0.05)).astype(np.float32)
    return lambda: eng(rgb, d, rgb, d)


def _train_step(h, w):
    cfg = TrainConfig(batch_size=4, optimizer=OptimizerConfig("adamw", 1e-3, 1e-7))
    trainer = Trainer(UnguidedTask(NConvUNet(device="cuda")), cfg)
    batch = {k: torch.from_numpy(v).cuda() for k, v in bench_batch(4, h, w).items()}
    return lambda: trainer.train_step(batch)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--train", action="store_true", help="trace step-1 train steps (f32)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    h, w = 352, 1216
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    run = _train_step(h, w) if args.train else _request(dtype, h, w)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = {}  # device-side events only (kernels, copies), by name
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_name[evt.name] = per_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    busy_ms = sum(per_name.values()) / 1e3 / args.frames
    wall_ms = wall * 1e3 / args.frames
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    out = {
        "card": card, "what": "train_step" if args.train else "request",
        "dtype": "f32" if args.train else args.dtype, "hw": [h, w], "frames": args.frames,
        "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms if per_name else "not measured",
        "device_busy_share": busy_ms / wall_ms if per_name else "not measured",
        "device_ms_per_request": {
            k: v / 1e3 / args.frames for k, v in sorted(per_name.items(), key=lambda kv: -kv[1])
        },
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
