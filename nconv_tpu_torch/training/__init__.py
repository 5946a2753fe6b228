"""Training of the port: step 1 (``UnguidedTask``) and step 2 (``GuidedTask``)
on one device or data-parallel over a mesh of ranks (``Trainer(mesh=...)``),
the learning-rate x weight-decay grid (one cell after another, or in
lockstep over one or more devices), best-model files."""
from .checkpoint import CheckpointManager, load_best, save_best
from .config import GridSearchConfig, OptimizerConfig, SchedulerConfig, TrainConfig
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
from .trainer import FitResult, GuidedTask, Trainer, UnguidedTask, grid_search
from .grid_parallel import parallel_grid_search

__all__ = [
    "CheckpointManager", "ConstantScheduler", "FitResult", "GridSearchConfig", "GuidedTask",
    "LinearScheduler", "OptimizerConfig", "PlateauScheduler", "RMSprop", "SchedulerConfig",
    "TrainConfig", "Trainer", "UnguidedTask", "build_optimizer", "build_scheduler", "evaluate",
    "get_learning_rate", "grid_search", "load_best", "make_guided_predict", "make_unguided_predict",
    "parallel_grid_search", "save_best", "set_learning_rate",
]
