"""Optimizers and learning-rate schedules with the semantics the JAX
package builds in optax (``nconv_tpu/training/optim.py``).

``torch.optim.AdamW`` (betas (0.9, 0.999), eps 1e-8, decoupled decay) and
``torch.optim.SGD`` (decay added to the gradient before momentum) compute
what optax's ``adamw`` and ``add_decayed_weights`` + ``sgd`` do. optax's
``rmsprop`` does not match ``torch.optim.RMSprop``: it keeps eps inside the
square root, g / sqrt(nu + eps), and its momentum traces the update after
the learning rate is applied; :class:`RMSprop` writes that out.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch

from .config import OptimizerConfig, SchedulerConfig


class RMSprop(torch.optim.Optimizer):
    """optax ``add_decayed_weights(wd)`` then ``rmsprop(lr, decay, eps,
    momentum)``::

        g   = grad + wd * p
        nu  = (1 - decay) * g**2 + decay * nu
        t   = -lr * g / sqrt(nu + eps) + momentum * t
        p  += t
    """

    def __init__(self, params, lr: float, *, decay: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop takes no closure")
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                state["nu"] = (1 - decay) * g**2 + decay * state["nu"]
                update = torch.rsqrt(state["nu"] + eps) * g * -lr
                state["trace"] = update + group["momentum"] * state["trace"]
                p.add_(state["trace"])


def build_optimizer(cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The optimizer over the parameters that require grad (a frozen
    parameter gets no update and no weight decay)."""
    params = [p for p in params if p.requires_grad]
    if cfg.name == "adamw":
        return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.name == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    if cfg.name == "rmsprop":
        return RMSprop(params, cfg.learning_rate, decay=0.99, eps=1e-8,
                       momentum=cfg.momentum, weight_decay=cfg.weight_decay)
    raise ValueError(f"Unsupported optimizer {cfg.name!r}. Choose 'adamw', 'sgd', or 'rmsprop'.")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class PlateauScheduler:
    """Reduce the LR by ``factor`` when the loss has not improved (strictly)
    for more than ``patience`` epochs."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 2):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.num_bad = 0

    def step(self, val_loss: float) -> float:
        if val_loss < self.best:
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        # JSON-safe: inf (the pristine 'best') round-trips as None
        best = self.best if math.isfinite(self.best) else None
        return {"lr": self.lr, "best": best, "num_bad": self.num_bad}

    def load_state_dict(self, sd: dict) -> None:
        self.lr = float(sd["lr"])
        self.best = float("inf") if sd.get("best") is None else float(sd["best"])
        self.num_bad = int(sd["num_bad"])


class LinearScheduler:
    """LR from ``base_lr`` down to 0 over ``total_epochs``, stepped per epoch."""

    def __init__(self, base_lr: float, total_epochs: int):
        self.base_lr = base_lr
        self.total = total_epochs
        self.epoch = 0

    def step(self, val_loss: float | None = None) -> float:
        self.epoch = min(self.epoch + 1, self.total)
        return self.base_lr * (1.0 - self.epoch / self.total)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch}

    def load_state_dict(self, sd: dict) -> None:
        self.epoch = int(sd["epoch"])


class ConstantScheduler:
    def __init__(self, base_lr: float):
        self.lr = base_lr

    def step(self, val_loss: float | None = None) -> float:
        return self.lr

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, sd: dict) -> None:
        pass


def build_scheduler(cfg: SchedulerConfig, base_lr: float, total_epochs: int):
    if cfg.kind == "plateau":
        return PlateauScheduler(base_lr, cfg.factor, cfg.patience)
    if cfg.kind == "linear":
        return LinearScheduler(base_lr, total_epochs)
    if cfg.kind == "constant":
        return ConstantScheduler(base_lr)
    raise ValueError(f"Unsupported scheduler kind {cfg.kind!r}")
