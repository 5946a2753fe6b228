"""Host ms of one two-stream KITTI frame's dense wire encode, by thread count.

    python3 scripts/encode_scan.py [--height 352] [--width 1216] [--reps 400]
                                   [--threads 1,2,3,4,5,6,8]

Times ``native.encode_frame_dense`` (both streams in one call, row bands on
the C library's threads, the calling thread included) beside the per-stream encode that ``StreamingEngine.run()``'s
staging workers keep (a numpy copy of each uint8 RGB frame and
``native.encode_depth_wire``), on u8 RGB and 5%-sparse float depth, into
one set of output buffers. The forms run in turns, ``reps`` rounds, so
that a slow stretch of the host falls on all of them. Prints one JSON
object: the CPUs the process may run on, ``encode_threads()``, and per
form the median and quartiles of the host ms a frame.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from nconv_tpu_torch.data import native  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=352)
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--threads", default="1,2,3,4,5,6,8")
    args = ap.parse_args(argv)
    h, w = args.height, args.width
    rng = np.random.default_rng(0)
    rgb = [(rng.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(2)]
    depth = [(rng.random((h, w)) * 80 * (rng.random((h, w)) < 0.05)).astype(np.float32) for _ in range(2)]
    out = tuple(np.zeros(shape, dt) for shape, dt in (((1, h, w, 3), np.uint8), ((1, h, w, 1), np.uint16)) * 2)

    def per_stream():
        for s in (0, 1):
            out[2 * s][0] = rgb[s]
            native.encode_depth_wire(depth[s][None, :, :, None], 256.0, out=out[2 * s + 1])

    forms = {"per_stream": per_stream}
    for t in (int(x) for x in args.threads.split(",")):
        forms[f"threads_{t}"] = lambda t=t: native.encode_frame_dense(rgb[0], depth[0], rgb[1], depth[1], out,
                                                                       threads=t)
    ms = {k: [] for k in forms}
    for fn in forms.values():  # the library's build and the pool's threads
        fn()
    for _ in range(args.reps):
        for k, fn in forms.items():
            t0 = time.perf_counter()
            fn()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    smi = shutil.which("nvidia-smi")
    card = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip() if smi else "no card"
    result = {
        "card": card,
        "cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)), "encode_threads": native.encode_threads(),
        "hw": [h, w], "reps": args.reps,
        "ms": {k: dict(zip(("p25", "p50", "p75"), statistics.quantiles(v, n=4))) for k, v in ms.items()},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
