"""Training (mirror of targetvae_tpu/train): the train state, Adam, and the
Trainer's step, on one device or grid-sharded over ranks (sp=True). Epoch
loops, schedules, checkpoints and logging are not ported yet (ROADMAP.md,
queue 1, items 11-14)."""

from .loop import Trainer
from .state import (TrainState, create_train_state, get_learning_rate,
                    make_optimizer, set_learning_rate)

__all__ = ["Trainer", "TrainState", "create_train_state", "make_optimizer",
           "set_learning_rate", "get_learning_rate"]
