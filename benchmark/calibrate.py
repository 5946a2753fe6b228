"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (set-up is long, so the seeds share it).

    python3 -m benchmark.calibrate --workload NAME --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 2]

For each of ``--seeds``: a whole run of the cell (set-up, a window of
``--seconds``, the check) and its compared numbers: the program's readings,
whose largest is a limit's lower end. For each of ``--control-seeds``: the
control, the reference one precision below the configuration's put in the
program's place (serving: every frame of the seed's ring; training: the
first three steps), and for training the faults of half the batch left
out and of each loss altered by 1%, planted in the reference put in the
program's place; their smallest is a limit's upper end. A cell whose loop
is a loop file (``benchmark/loops/<loop>.py``) takes its control and faults
from that file's ``control``. Prints one JSON object a line; the
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import cells, check, generate, spec
from .reference import precision
from .run import run_cell


def control_readings(cell, seed: int, device) -> dict:
    if cell.traffic["loop"] not in cells.LOOPS:
        return cell.loop_file().control(cell, seed, device)
    cfg, traffic = cell.config, cell.traffic
    correct = cfg["correct"]
    if cell.traffic["loop"] == "train":
        state = cells.step1_state(cfg, seed, device)
        batches = generate.batches(traffic["batches"], cfg["batch"], cfg["height"], cfg["width"], seed)
        batches = batches[: cells.Train.CHECKED_STEPS]
        ref = check.reference_training(cfg, state, batches, device, conv=correct["precision"]["conv"])
        control = check.reference_training(cfg, state, batches, device, conv=correct["control"]["conv"])
        out = {"control": check.compare_training(control, ref)}
        for fault in ("half_batch", "altered"):
            planted = check.reference_training(cfg, state, batches, device, conv=correct["precision"]["conv"],
                                               fault=fault)
            out[fault] = check.compare_training(planted, ref)
        return out
    state = cells.guided_state(seed, device)
    frames = generate.frames(traffic["frames"], cfg["height"], cfg["width"], seed)
    ring = range(len(frames))
    ref = check.reference_outputs(cfg, state, frames, ring, device, correct["precision"])
    control = check.reference_outputs(cfg, state, frames, ring, device, correct["control"])
    return {"control": check.compare_serving(list(control.items()), ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = spec.load(Path.cwd(), args.workload)
    device = "cuda"
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    precision.no_tf32()
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        result = run_cell(cell, seed, args.seconds, False, device, time.time())
        print(json.dumps({"workload": cell.name, "seed": seed, "kind": "program", "correct": result["correct"],
                          "readings": {n: v["value"] for n, v in result["checks"].items()},
                          "metrics": {n: v["value"] for n, v in result["metrics"].items()}}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        for kind, readings in control_readings(cell, seed, device).items():
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
