"""Training state: the model, Adam and the sampling generator
(mirror of targetvae_tpu/train/state.py).

optax.adam becomes torch.optim.Adam with the same semantics: bias-corrected
moments and eps outside the square root, update = -lr m_hat / (sqrt(v_hat) +
eps), betas (0.9, 0.999), eps 1e-8. The JAX state is immutable and replaced
by every step; this one is updated in place: the optimizer writes the
parameters and Adam's moments where they lie, and Trainer.train_step returns
the same TrainState with its step advanced. The learning rate lives in the
optimizer's param_groups, where a host-side controller can change it between
epochs.

A tensor-parallel state (tp > 1 without sp, parallel/pjit.py::shard_state)
holds `shards`: the optimizer then steps this rank's shards of the sharded
leaves (and the replicated leaves whole), and the model's whole parameters
are rebuilt from the shards after each step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional

import torch

from ..models.targetvae import TargetVAE


@dataclass
class TrainState:
    step: int
    model: TargetVAE                       # its modules hold the parameters
    optimizer: torch.optim.Adam
    generator: Optional[torch.Generator]   # sampling noise; None: no noise
    shards: Optional[Any] = None           # parallel.pjit.ParamShards (TP)


def make_optimizer(params: Iterable[torch.Tensor],
                   learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def create_train_state(model: TargetVAE, learning_rate: float,
                       generator: Optional[torch.Generator]) -> TrainState:
    """Adam over the model's parameters (the Fourier w and b are buffers,
    never trained, as their JAX gradients are zero)."""
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               learning_rate),
                      generator=generator)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])
