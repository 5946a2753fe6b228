"""The learning-rate x weight-decay grid trained in lockstep (the JAX
package's ``training/grid_parallel.py``).

The JAX package stacks every cell's train state on a leading axis and
``vmap``s one jitted step over it. The port's kernels are ctypes launches,
which ``torch.func.vmap`` cannot batch, and stacking cells on the batch
axis would need per-sample weights in every kernel. So the cells run in
lockstep instead: each batch is decoded and staged to the device once, then
every cell takes its step on it before the next batch, all on the current
stream (a CUDA stream a cell was slower on the H100: the host launches
every kernel either way; PERF.md §6). Each cell keeps its own model,
optimizer (its lr and wd), plateau scheduler and best-state tracking; all
start from one shared initial state, and every cell runs the full epoch
budget (no early stop). Given loaders that yield the same batches each
epoch, a cell computes exactly what
:func:`~nconv_tpu_torch.training.trainer.grid_search` computes for it.

``devices`` spreads the cells over several devices, the JAX package's
sharding of the cell axis over a mesh: the largest divisor of the cell
count that fits the device count takes that many devices, each holding an
equal, contiguous group of cells that runs in lockstep. Each batch is
staged once a device, and every device's steps are launched before the
host waits on any. On one device this is the one-device grid, bit for bit.
"""
from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from ..data.pipeline import prefetch_to_device
from ..models.backend import resolve_device
from .config import GridSearchConfig, TrainConfig
from .optim import build_scheduler, set_learning_rate
from .trainer import FitResult, Trainer, _host_copy, cell_config, cell_name


def _largest_divisor_leq(n: int, cap: int) -> int:
    d = min(n, cap)
    while n % d:
        d -= 1
    return d


def _staged(loader, devices):
    """Each batch of ``loader()`` as ``{device: batch on it}``, staged once
    a distinct device (``prefetch_to_device`` on each)."""
    distinct = list(dict.fromkeys(devices))
    feeds = [prefetch_to_device(it, d) for it, d in zip(itertools.tee(loader(), len(distinct)), distinct)]
    for batches in zip(*feeds):
        yield dict(zip(distinct, batches))


def parallel_grid_search(
    task_factory: Callable[[], object],
    cfg: TrainConfig,
    grid: GridSearchConfig,
    train_loader,
    val_loader,
    log_fn: Callable[[str], None] = print,
    device: str | torch.device | None = "cuda",
    devices=None,
):
    """Train every (lr, wd) cell in lockstep; returns ``(best FitResult,
    best lr, best wd)`` as :func:`grid_search` does, the winner's history
    holding every cell's under ``"cells"``. ``devices`` (a list) spreads
    the cells over those devices in place of ``device``."""
    cells = [(lr, wd) for lr in grid.learning_rates for wd in grid.weight_decays]
    devices = [resolve_device(d) for d in (devices if devices is not None else [device])]
    devices = devices[:_largest_divisor_leq(len(cells), len(devices))]
    per = len(cells) // len(devices)
    cell_devices = [devices[i // per] for i in range(len(cells))]
    tasks = [task_factory() for _ in cells]
    init = _host_copy(tasks[0].model)  # one shared initial state
    trainers = []
    for task, (lr, wd), dev in zip(tasks, cells, cell_devices):
        task.model.load_state_dict(init)
        trainers.append(Trainer(task, cell_config(cfg, lr, wd), log_fn=log_fn, device=dev))
    scheds = [build_scheduler(cfg.scheduler, lr, cfg.epochs) for lr, _ in cells]
    history = {cell_name(lr, wd): {"train_loss": [], "val_loss": [], "lr": []} for lr, wd in cells}
    best_val = np.full(len(cells), np.inf)
    best_state: list[dict | None] = [None] * len(cells)

    for epoch in range(cfg.epochs):
        losses = [[] for _ in cells]
        for staged in _staged(train_loader, devices):
            for t, dev, out in zip(trainers, cell_devices, losses):
                out.append(t.train_step(staged[dev]))
        vals = [[] for _ in cells]
        for staged in _staged(val_loader, devices):
            for t, dev, out in zip(trainers, cell_devices, vals):
                out.append(t.eval_step(staged[dev]))
        for i, (t, (lr, wd)) in enumerate(zip(trainers, cells)):
            train_l = float(torch.stack(losses[i]).mean()) if losses[i] else float("nan")
            val_l = float(np.mean([float(v) for v in vals[i]])) if vals[i] else float("nan")
            if val_l < best_val[i]:
                best_val[i] = val_l
                best_state[i] = _host_copy(t.model)
            new_lr = scheds[i].step(val_l)
            set_learning_rate(t.optimizer, new_lr)
            h = history[cell_name(lr, wd)]
            h["train_loss"].append(train_l)
            h["val_loss"].append(val_l)
            h["lr"].append(new_lr)
        log_fn(f"[pgrid epoch {epoch}] val "
               + " ".join(f"{h['val_loss'][-1]:.4f}" for h in history.values()))

    i = int(np.argmin(best_val))
    lr, wd = cells[i]
    state = best_state[i] if best_state[i] is not None else _host_copy(trainers[i].model)
    result = FitResult(state, float(best_val[i]), {**history[cell_name(lr, wd)], "cells": history})
    return result, lr, wd
