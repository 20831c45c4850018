from .checkpoints import (
    CheckpointManager,
    load_checkpoint,
    restore_state,
    save_checkpoint,
)
from .trainer import (
    EpochMetrics,
    Trainer,
    TrainerConfig,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "CheckpointManager",
    "load_checkpoint",
    "restore_state",
    "save_checkpoint",
    "EpochMetrics",
    "Trainer",
    "TrainerConfig",
    "make_eval_step",
    "make_train_step",
]
