"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Set-up (imports, the kernels' build on a
checkout's first run, inputs and weights from the seed, the program built
and warmed) counts from the process's start to the window's; then the
window runs ``S`` seconds; then, with the program freed, the check
compares what the window produced with the plain reference. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``;
``checks`` last, each compared number beside its limit, which the last
lines of standard error repeat.

Exits non-zero with no result line without CUDA or with fewer cards than
the cell asks for, and if the process has loaded ``jax``, ``jaxlib``,
``flax`` or ``nconv_tpu`` by the window's close.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "nconv_tpu")


def process_start() -> float:
    """This process's start on the wall clock, from ``/proc`` (to 10 ms)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _number(x: float):
    return x if math.isfinite(x) else None


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device, started: float) -> dict:
    """Set-up, window and check of ``cell`` (a :class:`.spec.Cell`) on
    ``device``; returns the result line's object."""
    import torch

    from . import check, trace
    from .reference import precision

    precision.no_tf32()
    torch.set_num_threads(2)
    imported = time.time() - started
    loop = cell.loop()(cell.config, cell.traffic, seed, device)
    setup_s = time.time() - started
    window = loop.window(seconds, trace_on)
    t_check = time.perf_counter()
    card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(device) if card else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if card else 0}
    loop.release()
    correct, table = check.judge(cell.config, loop.check())
    parts = " ".join(f"{k} {v:.3f}" for k, v in loop.phases.parts.items())
    print(f"set-up s: start to loop {imported:.3f} {parts}; check s {time.perf_counter() - t_check:.3f}",
          file=sys.stderr)

    metrics, out = {}, {}
    if trace_on:
        traced = window.traced
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = trace.breakdown(traced)
    else:
        values = dict(window.values, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": window.attempted, "failed": 0,
              "metrics": metrics, "device": dev, **out,
              "checks": {n: {"value": _number(v["value"]), "limit": v["limit"]} for n, v in table.items()}}
    return result


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    cell = spec.load(Path.cwd(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
