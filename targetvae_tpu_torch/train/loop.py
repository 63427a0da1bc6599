"""The training step and the epoch loop (mirror of
targetvae_tpu/train/loop.py: Trainer's _step_impl and _eval_impl over the
plain compute_elbo loss, its grid-sharded _loss_fn_sp, train_epoch,
eval_epoch and _pad_tail).

A step is eager PyTorch: the ELBO forward on the chosen tier, autograd
backward (on the bf16 tier through the K2 or, on the patch encoder tier,
K12, and the K4 and K8 backward kernels), and one in-place Adam step.

An epoch takes its batches from a data tensor that lies on the model's
device (fit() puts it there once), gathered by index_select in the order of
torch.randperm drawn from the state's generator; the ragged tail runs as one
smaller batch (drop_last=False), as the JAX package runs it on one device.
Per-image CTF kernels (the particles' Gaussian likelihood), where given,
lie on the device beside the data and are gathered by the same indices.
The metrics stay on the device and are read once per chunk of
progress_chunk batches, one chunk behind the steps being queued, so the
host does not wait for the card after every step.

With TrainConfig(sp=True, tp=T) the bf16 step runs on T ranks of an
initialised torch.distributed process group (parallel/), each calling
train_step with the same whole batch: the posterior's cells are sharded
over the ranks (K5/K6, parallel/grid_softmax.py), and each rank runs the
encoder and decoder on its B/T rows. Weighted rows and CTF kernels on that
step (a ragged tail padded over the ranks; the particles' likelihood), host
streams, dp > 1 and TP parameter sharding are not ported yet (ROADMAP.md,
queue 1, items 22-24).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..losses.elbo import (_normal_noise, compute_elbo, reconstruct_log_prob,
                           sp_shard_constants)
from ..models.encoders import encoder_heads
from ..models.targetvae import TargetVAE, resolve_device
from ..ops.gumbel import gumbel_noise
from ..parallel.grid_softmax import (chunks_to_cells, heads_to_chunks,
                                     sp_posterior)
from ..parallel.mesh import make_mesh
from ..utils.config import ModelConfig, TrainConfig
from .state import TrainState, create_train_state

_HOST_FEED = ("host_stream", "stream_bf16")
# the per-rank cell shard is padded to a multiple of this, as the JAX
# package's SP kernel tiles it, so that the shards match the JAX package's
SP_CELL_UNIT = 1024


class Trainer:
    def __init__(self, model: Union[TargetVAE, ModelConfig],
                 train_cfg: TrainConfig, device=None):
        """model: a TargetVAE, or a ModelConfig to build one on `device`
        (None means cuda:0, and raises without CUDA: pass device='cpu').
        sp=True needs tp > 1, dp = 1, compute_dtype 'bfloat16' and a
        process group of tp ranks (parallel.distributed.initialize)."""
        if train_cfg.compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"unsupported compute_dtype {train_cfg.compute_dtype!r}")
        changed = [f for f in _HOST_FEED
                   if getattr(train_cfg, f) != getattr(TrainConfig, f)]
        if changed:
            raise NotImplementedError(
                f"TrainConfig fields {changed} select a host feed, which the "
                "port does not have yet (ROADMAP.md, queue 1, item 22)")
        if train_cfg.dp != 1:
            raise NotImplementedError(
                f"TrainConfig dp={train_cfg.dp}: data parallelism is not "
                "ported yet (ROADMAP.md, queue 1, item 23)")
        self._mesh = None
        mode = (model if isinstance(model, ModelConfig)
                else model.cfg).encoder.mode
        if train_cfg.sp and mode != "C":
            raise NotImplementedError(
                f"sp=True with encoder mode {mode}: the grid-sharded "
                "posterior is ported for mode C only; mode B's waits "
                "(ROADMAP.md, queue 1, item 24), and mode A has no grid to "
                "shard")
        if train_cfg.sp:
            if train_cfg.tp <= 1:
                raise ValueError("sp=True shards the posterior grid over the "
                                 "model axis; it requires tp > 1")
            if train_cfg.compute_dtype != "bfloat16":
                raise NotImplementedError(
                    "sp=True runs on the bf16 kernel tier; the float32 "
                    "tier's SP branch (compute_elbo(sp=...), "
                    "make_joint_posterior) is not ported (ROADMAP.md)")
            self._mesh = make_mesh(model=train_cfg.tp)
        elif train_cfg.tp != 1:
            raise NotImplementedError(
                f"TrainConfig tp={train_cfg.tp} without sp: tensor-parallel "
                "parameter sharding is not ported yet (ROADMAP.md, queue 1, "
                "item 23)")
        if isinstance(model, ModelConfig):
            model = TargetVAE(model, device)
        elif device is not None and resolve_device(device) != model.device:
            raise ValueError(f"model is on {model.device}, not {device}")
        self.model = model
        self.cfg = train_cfg
        self.batch = train_cfg.minibatch_size
        self.compute_dtype = (torch.bfloat16
                              if train_cfg.compute_dtype == "bfloat16" else None)
        self._x_coord = model.base_grid()

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters and Adam state. One generator seeded `seed` draws
        the parameters and then goes on to draw the training noise. Ranks
        given the same seed hold the same parameters and draw the same
        noise."""
        generator = torch.Generator().manual_seed(seed)
        self.model.init(generator)
        return create_train_state(self.model, self.cfg.learning_rate,
                                  generator)

    def _loss_fn(self, params: dict, y: torch.Tensor,
                 generator: Optional[torch.Generator],
                 w: Optional[torch.Tensor] = None,
                 ctf: Optional[torch.Tensor] = None):
        """(-elbo, log_p, kl) of batch y (and its CTF kernels) under params:
        batch means, or sums weighted by the rows' weights w."""
        elbo, log_p, kl = compute_elbo(params, self.model.cfg, self._x_coord,
                                       y, generator,
                                       compute_dtype=self.compute_dtype,
                                       row_weights=w, ctf=ctf)
        return -elbo, log_p, kl

    def _loss_fn_sp(self, params: dict, y: torch.Tensor,
                    generator: Optional[torch.Generator]):
        """This rank's (kl - log_p, log_p, kl), means over its own B/T rows
        of the whole batch y, with the posterior grid-sharded over the
        model axis (targetvae_tpu/train/loop.py::_loss_fn_sp)."""
        mesh = self._mesh
        t_n, t, group = mesh.model, mesh.rank, mesh.group
        cfg = self.model.cfg
        ecfg = cfg.encoder
        zd = ecfg.z_dim
        b = y.shape[0]
        if b % t_n:
            raise ValueError(f"a batch of {b} does not split over {t_n} ranks")
        b_l = b // t_n
        rows = slice(t * b_l, (t + 1) * b_l)
        dev = y.device
        const = sp_shard_constants(ecfg, dev, t_n, t, SP_CELL_UNIT)
        c_loc = const["c_loc"]
        heads = encoder_heads(params["encoder"], ecfg, y[rows],
                              self.compute_dtype)
        # batch-split -> cell-split: the raw heads, log p(r) and the offsets
        # added and the cells padded to t_n * c_loc (-1e30 logits, zero
        # moments; the pads carry exactly zero posterior mass and gradient)
        # in one pass into the send buffer, one exchange of all 3 + 2 zd
        # planes; K5/K6 read the received planes where they lie
        planes = chunks_to_cells(heads_to_chunks(
            heads.reshape(b_l, -1, 3 + 2 * zd), const["bias"], t_n, c_loc),
            group)
        # the Gumbel noise differs per rank (its generator's seed folded
        # with the rank); the reparameterisation noise is drawn for all B
        # rows and is the same on every rank, as the moments it scales
        if generator is None:
            noise = torch.zeros((b, c_loc), device=dev)
        else:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                     device=generator.device))
            noise = gumbel_noise((b, c_loc), torch.Generator(
                device=dev).manual_seed(seed + t), dev)
        out = sp_posterior(group, const["sig_r"], planes, noise, const["p"],
                           const["gx"], const["gy"], const["offs"])
        z_s = out[:, zd:2 * zd] * _normal_noise(generator, (b, zd), dev) \
            + out[:, :zd]
        theta = out[:, 2 * zd + 1] * _normal_noise(generator, (b,), dev) \
            + out[:, 2 * zd]
        # row s * b_l + r of the exchange is rank s's local row r
        log_p = reconstruct_log_prob(params, cfg, self._x_coord, y[rows],
                                     theta[rows],
                                     out[rows, 2 * zd + 2:2 * zd + 4],
                                     z_s[rows],
                                     compute_dtype=self.compute_dtype)
        kl = out[rows, 2 * zd + 4].mean()
        return kl - log_p, log_p, kl

    def _objective(self, params: dict, y: torch.Tensor,
                   generator: Optional[torch.Generator],
                   w: Optional[torch.Tensor] = None,
                   ctf: Optional[torch.Tensor] = None):
        """(the scalar this rank differentiates, the (3,) metrics [elbo,
        log_p, kl] of the whole batch). With sp the objective is this
        rank's loss divided by the number of ranks, so that the ranks'
        objectives add up to the batch mean, and the metrics are
        all-reduced."""
        if self._mesh is None:
            neg_elbo, log_p, kl = self._loss_fn(params, y, generator, w, ctf)
            return neg_elbo, torch.stack([-neg_elbo, log_p, kl]).detach()
        if ctf is not None:
            raise NotImplementedError(
                "CTF kernels on the grid-sharded step are not ported yet "
                "(ROADMAP.md, queue 1, item 24)")
        if w is not None:
            raise NotImplementedError(
                "row weights on the grid-sharded step (a ragged tail padded "
                "over the ranks) are not ported yet (ROADMAP.md, queue 1, "
                "item 24)")
        loss, log_p, kl = self._loss_fn_sp(params, y, generator)
        t_n = self._mesh.model
        metrics = torch.stack([-loss, log_p, kl]).detach() / t_n
        dist.all_reduce(metrics, group=self._mesh.group)
        return loss / t_n, metrics

    def on_device(self, y) -> Optional[torch.Tensor]:
        """y (an array or tensor) as float32 on the model's device, without
        a copy where it already is; a bf16 batch (or bf16 CTF kernels) is
        upcast, as the JAX loss does. None stays None."""
        if y is None:
            return None
        return torch.as_tensor(y).to(self.model.device, torch.float32)

    def train_step(self, state: TrainState, y,
                   row_weights: Optional[torch.Tensor] = None,
                   ctf=None) -> Tuple[TrainState, torch.Tensor]:
        """One Adam step on the batch y (B, H, W, C) with its CTF kernels
        ctf (B, kc, kc) where given, noise from state.generator (None:
        deterministic); row_weights (B,) turns the batch means into weighted
        sums. Returns (state, metrics) with
        metrics the (3,) tensor [elbo, log_p, kl] on the model's device;
        reading it waits for the step. The parameters, Adam's moments and
        state.step are updated in place. With sp every rank passes the same
        y and gets the same metrics and parameters."""
        state.optimizer.zero_grad(set_to_none=True)
        objective, metrics = self._objective(
            state.model.params(), self.on_device(y), state.generator,
            row_weights, self.on_device(ctf))
        objective.backward()
        if self._mesh is not None:
            self._mesh.all_reduce_grads(state.model.parameters())
        state.optimizer.step()
        state.step += 1
        return state, metrics

    def eval_step(self, state: TrainState, y,
                  generator: Optional[torch.Generator] = None,
                  row_weights: Optional[torch.Tensor] = None,
                  ctf=None) -> torch.Tensor:
        """[elbo, log_p, kl] of the batch y (with its CTF kernels ctf where
        given), no gradient; noise from `generator` (None: deterministic)."""
        with torch.inference_mode():
            return self._objective(state.model.params(), self.on_device(y),
                                   generator, row_weights,
                                   self.on_device(ctf))[1]

    # batches per chunk whose metrics are read together when a progress
    # callback wants mid-epoch reports
    progress_chunk = 50

    def train_epoch(self, state: TrainState, data, ctf=None, progress=None,
                    ) -> Tuple[TrainState, Tuple[float, float, float]]:
        """One epoch over `data` (N, H, W, C) and its CTF kernels `ctf` (N,
        kc, kc) where given. Returns (state, (elbo, gen_loss, kl)) with
        gen_loss = -log_p, matching the reference's reported Error.

        The order is torch.randperm(N) drawn from state.generator (a state
        without one keeps the data's order); N // B full batches, then the
        tail as one batch of N % B. progress: optional callback(images_seen,
        elbo, gen_loss, kl) called with the reference's streaming-mean
        accumulators (train_mnist.py:326-345) every `progress_chunk`
        batches. A chunk's metrics are read once the next chunk's steps are
        queued."""
        data, ctf = self.on_device(data), self.on_device(ctf)
        n = data.shape[0]
        b = min(self.batch, n)
        g = state.generator
        perm = (torch.arange(n) if g is None
                else torch.randperm(n, generator=g, device=g.device)
                ).to(data.device)
        n_full = n // b
        chunk = n_full if progress is None else min(self.progress_chunk,
                                                    n_full)
        metrics, weights = [], []
        pending, block = None, []
        for i in range(n_full):
            idx = perm[i * b:(i + 1) * b]
            state, m = self.train_step(state, data.index_select(0, idx),
                                       ctf=_rows(ctf, idx))
            block.append(m)
            if len(block) == chunk or i == n_full - 1:
                if pending is not None:    # waits for the PREVIOUS chunk
                    _collect(pending, b, metrics, weights)
                    if progress is not None:
                        progress(int(sum(weights)),
                                 *_streaming_means(metrics, weights))
                pending, block = torch.stack(block), []
        if pending is not None:
            _collect(pending, b, metrics, weights)

        rem = n - n_full * b
        if rem:
            tail, w = self._pad_tail(perm[n_full * b:], rem)
            state, m = self.train_step(state, data.index_select(0, tail), w,
                                       _rows(ctf, tail))
            _collect(m[None], rem, metrics, weights)
        return state, _weighted_mean(np.concatenate(metrics), weights)

    def _pad_tail(self, tail: torch.Tensor, rem: int):
        """Pad a ragged tail's index vector to the next multiple of the
        ranks by repeating its first row with ZERO weight, the real rows
        carrying 1/rem (their loss, gradients and metrics equal the
        unpadded tail's batch means). With no mesh: (tail, None), the tail
        runs as a smaller batch."""
        pad = 0 if self._mesh is None else (-rem) % self._mesh.model
        if not pad:
            return tail, None
        tail = torch.cat([tail, tail[:1].expand(pad)])
        w = torch.cat([torch.full((rem,), 1.0 / rem), torch.zeros(pad)])
        return tail, w.to(tail.device)

    def eval_epoch(self, state: TrainState, data, ctf=None, seed: int = 0,
                   ) -> Tuple[float, float, float]:
        """(elbo, gen_loss, kl) over `data` (and its CTF kernels `ctf`) in
        order, batches of B and the tail, sampled with a generator seeded
        `seed`."""
        data, ctf = self.on_device(data), self.on_device(ctf)
        n = data.shape[0]
        b = min(self.batch, n)
        n_full = n // b
        gen = torch.Generator().manual_seed(seed)
        out = [self.eval_step(state, data[i * b:(i + 1) * b], gen,
                              ctf=None if ctf is None
                              else ctf[i * b:(i + 1) * b])
               for i in range(n_full)]
        weights = [float(b)] * n_full
        rem = n - n_full * b
        if rem:
            tail, w = self._pad_tail(
                torch.arange(n_full * b, n, device=data.device), rem)
            out.append(self.eval_step(state, data.index_select(0, tail), gen,
                                      w, _rows(ctf, tail)))
            weights.append(float(rem))
        return _weighted_mean(torch.stack(out).cpu().numpy(), weights)


def _rows(v: Optional[torch.Tensor], idx: torch.Tensor
          ) -> Optional[torch.Tensor]:
    """The rows idx of v (the CTF kernels), or None without v."""
    return None if v is None else v.index_select(0, idx)


def _collect(pending: torch.Tensor, b: int, metrics: list,
             weights: list) -> None:
    """Read a (k, 3) block of step metrics to the host, each step weighing
    its batch size b."""
    host = pending.cpu().numpy()
    metrics.append(host)
    weights += [float(b)] * host.shape[0]


def _weighted_mean(metrics: np.ndarray, weights) -> Tuple[float, float, float]:
    """metrics (nb, 3) of (elbo, log_p, kl) -> (elbo, gen_loss, kl)."""
    w = np.asarray(weights)[:, None]
    m = (metrics * w).sum(0) / w.sum()
    return float(m[0]), float(-m[1]), float(m[2])


def _streaming_means(metrics, weights) -> Tuple[float, float, float]:
    """Running (elbo, gen_loss, kl) over the batches seen so far — the
    weighted mean the reference's per-minibatch accumulators converge to
    (train_mnist.py:330-338)."""
    return _weighted_mean(np.concatenate(metrics), weights)
