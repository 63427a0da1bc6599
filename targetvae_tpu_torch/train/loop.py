"""The single-device training step (mirror of targetvae_tpu/train/loop.py,
Trainer._step_impl and _eval_impl over the plain compute_elbo loss).

A step is eager PyTorch: the ELBO forward on the chosen tier, autograd
backward (on the bf16 tier through the K2 or, on the patch encoder tier,
K12, and the K4 and K8 backward kernels), and one in-place Adam step. The JAX package's epoch scans, ragged-tail
padding with row weights, host streams and meshes are not ported yet
(ROADMAP.md, queue 1, item 11 and later).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..losses.elbo import compute_elbo
from ..models.targetvae import TargetVAE, resolve_device
from ..utils.config import ModelConfig, TrainConfig
from .state import TrainState, create_train_state

_ONE_DEVICE = ("dp", "tp", "sp", "host_stream", "stream_bf16")


class Trainer:
    def __init__(self, model: Union[TargetVAE, ModelConfig],
                 train_cfg: TrainConfig, device=None):
        """model: a TargetVAE, or a ModelConfig to build one on `device`
        (None means cuda:0, and raises without CUDA: pass device='cpu')."""
        changed = [f for f in _ONE_DEVICE
                   if getattr(train_cfg, f) != getattr(TrainConfig, f)]
        if changed:
            raise NotImplementedError(
                f"TrainConfig fields {changed} select a mesh or a host feed, "
                "which the port does not have yet; it trains on one device")
        if train_cfg.compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"unsupported compute_dtype {train_cfg.compute_dtype!r}")
        if isinstance(model, ModelConfig):
            model = TargetVAE(model, device)
        elif device is not None and resolve_device(device) != model.device:
            raise ValueError(f"model is on {model.device}, not {device}")
        self.model = model
        self.cfg = train_cfg
        self.compute_dtype = (torch.bfloat16
                              if train_cfg.compute_dtype == "bfloat16" else None)
        self._x_coord = model.base_grid()

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters and Adam state. One generator seeded `seed` draws
        the parameters and then goes on to draw the training noise."""
        generator = torch.Generator().manual_seed(seed)
        self.model.init(generator)
        return create_train_state(self.model, self.cfg.learning_rate,
                                  generator)

    def _loss_fn(self, params: dict, y: torch.Tensor,
                 generator: Optional[torch.Generator]):
        """(-elbo, log_p, kl) of batch y under params."""
        elbo, log_p, kl = compute_elbo(params, self.model.cfg, self._x_coord,
                                       y, generator,
                                       compute_dtype=self.compute_dtype)
        return -elbo, log_p, kl

    def _on_device(self, y) -> torch.Tensor:
        # a bf16 batch is upcast, as the JAX loss does
        return torch.as_tensor(y).to(self.model.device, torch.float32)

    def train_step(self, state: TrainState, y
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One Adam step on the batch y (B, H, W, C), noise from
        state.generator (None: deterministic). Returns (state, metrics) with
        metrics the (3,) tensor [elbo, log_p, kl] on the model's device;
        reading it waits for the step. The parameters, Adam's moments and
        state.step are updated in place."""
        y = self._on_device(y)
        state.optimizer.zero_grad(set_to_none=True)
        neg_elbo, log_p, kl = self._loss_fn(state.model.params(), y,
                                            state.generator)
        neg_elbo.backward()
        state.optimizer.step()
        state.step += 1
        return state, torch.stack([-neg_elbo, log_p, kl]).detach()

    def eval_step(self, state: TrainState, y,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """[elbo, log_p, kl] of the batch y, no gradient; noise from
        `generator` (None: deterministic)."""
        with torch.inference_mode():
            neg_elbo, log_p, kl = self._loss_fn(state.model.params(),
                                                self._on_device(y), generator)
            return torch.stack([-neg_elbo, log_p, kl])
