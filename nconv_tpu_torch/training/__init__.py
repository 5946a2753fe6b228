"""Training of the port: step 1 (``UnguidedTask``) and step 2 (``GuidedTask``)
on one device."""
from .checkpoint import CheckpointManager
from .config import OptimizerConfig, SchedulerConfig, TrainConfig
from .evaluate import evaluate, make_guided_predict, make_unguided_predict
from .optim import (
    ConstantScheduler,
    LinearScheduler,
    PlateauScheduler,
    RMSprop,
    build_optimizer,
    build_scheduler,
    get_learning_rate,
    set_learning_rate,
)
from .trainer import FitResult, GuidedTask, Trainer, UnguidedTask

__all__ = [
    "CheckpointManager", "ConstantScheduler", "FitResult", "GuidedTask", "LinearScheduler",
    "OptimizerConfig", "PlateauScheduler", "RMSprop", "SchedulerConfig",
    "TrainConfig", "Trainer", "UnguidedTask", "build_optimizer",
    "build_scheduler", "evaluate", "get_learning_rate", "make_guided_predict",
    "make_unguided_predict", "set_learning_rate",
]
