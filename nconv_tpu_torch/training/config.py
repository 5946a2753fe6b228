"""Typed configuration of a training run (the JAX package's
``training/config.py``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | sgd | rmsprop
    learning_rate: float = 1e-2
    weight_decay: float = 1e-7
    momentum: float = 0.9  # sgd / rmsprop only


@dataclass(frozen=True)
class SchedulerConfig:
    """'plateau' (reduce by ``factor`` after ``patience`` bad epochs),
    'linear' (1 -> 0 over the run's epochs) or 'constant'."""

    kind: str = "plateau"  # plateau | linear | constant
    factor: float = 0.1
    patience: int = 2


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 40
    batch_size: int = 4
    eval_batch_size: int = 1
    use_gradient_loss: bool = True
    batch_reduce: str = "mean"  # multi-res loss; 'first' = exact reference
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    early_stopping: bool = False
    early_stop_extra: int = 3  # stop after patience + this many bad epochs
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    run_name: str = "run"
    checkpoint_every: int = 1  # epochs
    keep_checkpoints: int = 3
    log_every: int = 25  # batches
    dump_images_every: int = 0  # batches; 0 disables debug depth dumps
    image_dir: str = "tmp"
    # 'raise' aborts on a non-finite epoch loss (the checkpoint of the last
    # good epoch survives), 'ignore' keeps going
    nan_policy: str = "raise"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GridSearchConfig:
    """The learning-rate x weight-decay sweep of step-1 training."""

    learning_rates: Sequence[float] = (1e-2,)
    weight_decays: Sequence[float] = (1e-7,)
