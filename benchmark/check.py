"""What decides ``correct``: the program's outputs against the plain
reference (:mod:`.reference`), number by number, each against the limit
its configuration file states.

  * Serving: every depth map in the window's seeded sample against the
    reference's map of the same request; ``depth_rel_rmse`` is the worst
    over the sample and both streams of ||out - ref|| / ||ref||.
  * Training: the first three steps. ``loss_rel``: the worst step's
    |loss - ref| / |ref|. ``grad_gap``: over the leaves, the worst gap
    between the norm of the program's first gradient (from AdamW's first
    moment after one step) and the reference's, over the larger of the
    reference leaf's norm and the median leaf's. ``update_gap``: the same
    for each leaf's change over the three steps, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's.

A non-finite or missing reading counts as infinitely far.
"""
from __future__ import annotations

import math
import statistics

import torch

from .reference import guided, step1

ROUNDING_FLOOR = 1e-3  # of the median leaf's gradient norm: a leaf under it moves by round-off


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def rel_rmse(out: torch.Tensor, ref: torch.Tensor) -> float:
    out, ref = out.detach().double().reshape(-1), ref.detach().double().to(out.device).reshape(-1)
    return _finite(float((out - ref).norm() / ref.norm()))


@torch.no_grad()
def reference_outputs(cfg, state, frames, indices, device, prec):
    """The reference's two maps of each ring frame in ``indices``."""
    return {r: guided.export(state, frames[r], cfg, feature=prec["feature"], depth=prec["depth"], device=device)
            for r in sorted(set(indices))}


def compare_serving(sample, refs) -> dict:
    worst = math.inf if not sample else 0.0
    for r, outs in sample:
        for out, ref in zip(outs, refs[r]):
            worst = max(worst, rel_rmse(out, ref))
    return {"depth_rel_rmse": worst}


def serving_readings(cfg, state, frames, sample, device) -> dict:
    refs = reference_outputs(cfg, state, frames, [r for r, _ in sample], device, cfg["correct"]["precision"])
    return compare_serving(sample, refs)


def reference_training(cfg, state, batches, device, *, conv="f32", fault=None) -> dict:
    """The reference's readings of the first ``len(batches)`` steps: losses,
    first-gradient and change norms by leaf."""
    dev = [{k: torch.from_numpy(b[k]).to(device) for k in ("depth", "gt")} for b in batches]
    losses, first, params = step1.train(state, dev, cfg["optimizer"], conv=conv, fault=fault)
    return {"loss": losses, "grad": {n: float(g.norm()) for n, g in first.items()},
            "update": {n: float((p - state[n]).norm()) for n, p in params.items()}}


def _gap(prog: dict, ref: dict, names) -> float:
    scale = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        if n not in prog:
            return math.inf
        worst = max(worst, _finite(abs(prog[n] - ref[n]) / max(ref[n], scale)))
    return worst


def compare_training(prog: dict, ref: dict) -> dict:
    if len(prog["loss"]) != len(ref["loss"]):
        return {"loss_rel": math.inf, "grad_gap": math.inf, "update_gap": math.inf}
    loss = max(_finite(abs(a - b) / abs(b)) for a, b in zip(prog["loss"], ref["loss"]))
    names = list(ref["grad"])
    median_grad = statistics.median(ref["grad"].values())
    moving = [n for n in names if ref["grad"][n] >= ROUNDING_FLOOR * median_grad]
    return {"loss_rel": loss, "grad_gap": _gap(prog["grad"], ref["grad"], names),
            "update_gap": _gap(prog["update"], ref["update"], moving)}


def training_readings(cfg, state, batches, program, device) -> dict:
    return compare_training(program, reference_training(cfg, state, batches, device,
                                                        conv=cfg["correct"]["precision"]["conv"]))


def judge(cfg, readings: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {"value", "limit"}})."""
    limits = cfg["correct"]["limits"]
    table = {n: {"value": readings.get(n, math.inf), "limit": lim} for n, lim in limits.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table
