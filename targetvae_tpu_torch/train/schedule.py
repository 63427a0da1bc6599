"""Host-side training controllers: plateau LR schedule and early stopping
(mirror of targetvae_tpu/train/schedule.py).

ReduceLROnPlateau replicates torch's scheduler with the reference settings
(mode='max', factor=0.5, patience=9, threshold=1e-4 absolute, cooldown=0 —
train_mnist.py:581) on a plain float, which fit() hands to
train/state.py::set_learning_rate when it changes. EarlyStopping replicates
src/utils.py:7-48 (patience counter on test ELBO, improvement must exceed
delta, checkpoint-on-improve via a callback instead of pickling modules).
"""

from __future__ import annotations

import math
from typing import Callable, Optional


class ReduceLROnPlateau:
    def __init__(self, lr: float, mode: str = "max", factor: float = 0.5,
                 patience: int = 9, threshold: float = 1e-4,
                 min_lr: float = 0.0):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', not {mode!r}")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = -math.inf if mode == "max" else math.inf
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "max":
            return metric > self.best + self.threshold
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        """Update with this epoch's metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr


class EarlyStopping:
    """Stops training when test ELBO stops improving; saves best on improve."""

    def __init__(self, patience: int = 20, delta: float = 1e-4,
                 save_fn: Optional[Callable[[], None]] = None):
        self.patience = patience
        self.delta = delta
        self.save_fn = save_fn
        self.counter = 0
        self.max_elbo = -math.inf
        self.early_stop = False

    def __call__(self, elbo: float) -> str:
        if elbo < self.max_elbo + self.delta:
            self.counter += 1
            msg = "#EarlyStopping counter: {} out of {}".format(
                self.counter, self.patience)
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            msg = "#ELBO increased {:.4f}: --> {:.4f}.  Saving model ...".format(
                self.max_elbo, elbo)
            if self.save_fn is not None:
                self.save_fn()
            self.max_elbo = elbo
            self.counter = 0
        return msg
