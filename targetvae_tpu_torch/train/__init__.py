"""Training (mirror of targetvae_tpu/train): the train state and Adam, the
Trainer's step and epoch loops (resident or host-streamed; on one device,
or over ranks: dp data shards, the step grid-sharded with sp=True), the
plateau and early-stopping controllers, checkpoints in the JAX package's
format, run-directory logging and fit."""

from .checkpoint import (AsyncCheckpointer, load_checkpoint, load_train_state,
                         save_checkpoint, save_model_pair, save_train_state)
from .fit import fit
from .logging import NullLogger, RunLogger, run_dir_name
from .loop import Trainer
from .schedule import EarlyStopping, ReduceLROnPlateau
from .state import (TrainState, create_train_state, get_learning_rate,
                    make_optimizer, set_learning_rate)

__all__ = [
    "ReduceLROnPlateau", "EarlyStopping", "TrainState", "create_train_state",
    "make_optimizer", "set_learning_rate", "get_learning_rate",
    "save_checkpoint", "load_checkpoint", "save_model_pair",
    "save_train_state", "load_train_state", "AsyncCheckpointer", "Trainer",
    "NullLogger", "RunLogger", "run_dir_name", "fit",
]
