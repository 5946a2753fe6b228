"""Training of the port: step 1 (``UnguidedTask``) on one device."""
from .checkpoint import CheckpointManager
from .config import OptimizerConfig, SchedulerConfig, TrainConfig
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
from .trainer import FitResult, Trainer, UnguidedTask

__all__ = [
    "CheckpointManager", "ConstantScheduler", "FitResult", "LinearScheduler",
    "OptimizerConfig", "PlateauScheduler", "RMSprop", "SchedulerConfig",
    "TrainConfig", "Trainer", "UnguidedTask", "build_optimizer",
    "build_scheduler", "get_learning_rate", "set_learning_rate",
]
