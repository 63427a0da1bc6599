"""The training step and the epoch loops (mirror of
targetvae_tpu/train/loop.py: Trainer's _step_impl and _eval_impl over the
plain compute_elbo loss, its data-parallel _loss_fn_dp and grid-sharded
_loss_fn_sp, train_epoch, eval_epoch, the streamed train_epoch_stream and
eval_epoch_stream, and _pad_tail).

A step is eager PyTorch: the ELBO forward on the chosen tier, autograd
backward (on the bf16 tier through the K2 or, on the patch encoder tier,
K12, and the K4 and K8 backward kernels), and one in-place Adam step.

A resident epoch takes its batches from a data tensor that lies on the
model's device (fit() puts it there once), gathered by index_select in the
order of torch.randperm drawn from the state's generator; the ragged tail
runs as one smaller batch (drop_last=False), as the JAX package runs it on
one device. Per-image CTF kernels (the particles' Gaussian likelihood),
where given, lie on the device beside the data and are gathered by the same
indices. A streamed epoch takes fixed-size StreamBatch(y, ctf, w, n_real)
batches from a host feed (data/pipeline.py), the tail padded with
zero-weight rows. The metrics stay on the device and are read once per chunk
of progress_chunk batches, one chunk behind the steps being queued, so the
host does not wait for the card after every step.

Over ranks (parallel/mesh.py; an initialised torch.distributed process
group of dp * tp ranks) every rank calls the same entry points with the
same whole batch, or its data shard's rows of it (the epochs, the host
feed), and gets the same metrics and parameters. dp > 1 splits each batch
over the data axis: every rank runs the step with the kernels on its B / dp
rows and the gradients are all-reduced. tp > 1 without sp shards the
parameters and Adam's moments over the model axis (parallel/pjit.py) and
splits each batch over all dp * tp ranks, as the JAX package's _loss_fn_dp
splits it over both axes; the noise seed folds the flattened rank index.
TrainConfig(sp=True, tp=T) runs the step grid-sharded over the model axis
(losses/elbo.py::compute_elbo(sp=...)): the posterior's cells are sharded
over the T ranks of a data row (bf16: K5/K6; float32: the plain
posterior_block of parallel/grid_softmax.py), modes B and C, and each rank
runs the encoder and decoder on its rows. A ragged tail is padded over the
ranks with zero-weight rows; row weights and CTF kernels ride through every
form of the step.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# SP_CELL_UNIT is read from here by chip_smoke.py, whose timing tool runs
# it against older checkouts too, where it was defined here
from ..losses.elbo import SP_CELL_UNIT, compute_elbo  # noqa: F401
from ..models.targetvae import TargetVAE, resolve_device
from ..parallel.mesh import make_mesh
from ..parallel.pjit import shard_state
from ..utils.config import ModelConfig, TrainConfig
from ..utils.trace import span
from .state import TrainState, create_train_state

# a rank's noise seed: the shared generator's draw (< 2**31) folded with the
# rank's index over the batch's shards (the data index under sp, so that
# the ranks of one data row draw alike; the flattened index otherwise), as
# the JAX package folds its key
_FOLD = 2 ** 31


def check_train_config(model_cfg: ModelConfig, train_cfg: TrainConfig
                       ) -> None:
    """Raise on a TrainConfig the port does not run with this model: an
    unknown compute dtype, sp in mode A (no grid to shard) or below tp 2,
    tp or dp below 1."""
    if train_cfg.compute_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(
            f"unsupported compute_dtype {train_cfg.compute_dtype!r}")
    mode = model_cfg.encoder.mode
    if train_cfg.sp and mode == "A":
        raise NotImplementedError(
            "sp=True with encoder mode A: the unimodal posterior has no "
            "grid to shard (sp takes modes B and C)")
    if train_cfg.sp and train_cfg.tp <= 1:
        raise ValueError("sp=True shards the posterior grid over the "
                         "model axis; it requires tp > 1")
    if train_cfg.tp < 1:
        raise ValueError(f"TrainConfig tp={train_cfg.tp}: tp >= 1")
    if train_cfg.dp < 1:
        raise ValueError(f"TrainConfig dp={train_cfg.dp}: dp >= 1")


class Trainer:
    def __init__(self, model: Union[TargetVAE, ModelConfig],
                 train_cfg: TrainConfig, device=None):
        """model: a TargetVAE, or a ModelConfig to build one on `device`
        (None means cuda:0, and raises without CUDA: pass device='cpu').
        dp > 1 or tp > 1 needs an initialised process group of dp * tp
        ranks (parallel.distributed.initialize); sp=True also tp > 1 and
        an attention mode (B or C)."""
        check_train_config(model if isinstance(model, ModelConfig)
                           else model.cfg, train_cfg)
        self._mesh = (make_mesh(data=train_cfg.dp, model=train_cfg.tp)
                      if train_cfg.dp * train_cfg.tp > 1 else None)
        # tensor parallelism: the parameters sharded over the model axis
        self._tp = train_cfg.tp > 1 and not train_cfg.sp
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

    @property
    def mesh(self):
        """The (data, model) rank layout, or None on one process."""
        return self._mesh

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters and Adam state. One generator seeded `seed` draws
        the parameters and then goes on to draw the training noise. Ranks
        given the same seed hold the same parameters and draw the same
        noise. Under tensor parallelism each rank keeps its shards
        (parallel/pjit.py::shard_state)."""
        generator = torch.Generator().manual_seed(seed)
        self.model.init(generator)
        state = create_train_state(self.model, self.cfg.learning_rate,
                                   generator)
        return shard_state(state, self._mesh) if self._tp else state

    def batch_rows(self, b: int) -> slice:
        """The rows of a global batch of b that this rank takes: its data
        shard's under sp (the model axis splits them inside the step), its
        flattened shard's otherwise (all of them on one process). A host
        feed for this Trainer gathers these rows
        (HostDataPipeline(rows=...))."""
        if self._mesh is None:
            return slice(0, b)
        if b % self._mesh.size:
            raise ValueError(f"a batch of {b} does not split over the "
                             f"{self._mesh.data} x {self._mesh.model} ranks")
        if self.cfg.sp:
            return self._mesh.batch_rows(b)
        return self._mesh.flat_rows(b)

    def _row_shards(self) -> int:
        """The shards a batch's rows split into before the step: the data
        rows under sp, every rank otherwise."""
        return self._mesh.data if self.cfg.sp else self._mesh.size

    def _rank_seed(self, generator: torch.Generator) -> int:
        """The shared generator's next draw (the same on every rank) folded
        with this rank's shard of the batch: its data index under sp, its
        flattened index otherwise."""
        seed = int(torch.randint(0, _FOLD - 1, (1,), generator=generator,
                                 device=generator.device))
        mesh = self._mesh
        return seed + _FOLD * (mesh.data_index if self.cfg.sp
                               else mesh.flat_index)

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

    def _loss_fn_dp(self, params: dict, y: torch.Tensor,
                    generator: Optional[torch.Generator],
                    w: Optional[torch.Tensor] = None,
                    ctf: Optional[torch.Tensor] = None):
        """This rank's (-elbo, log_p, kl) over its rows y (its shard over
        both axes), with the kernels, its noise from the shared generator's
        seed folded with its flattened index
        (targetvae_tpu/train/loop.py::_loss_fn_dp)."""
        if generator is not None:
            generator = torch.Generator().manual_seed(
                self._rank_seed(generator))
        return self._loss_fn(params, y, generator, w, ctf)

    def _loss_fn_sp(self, params: dict, y: torch.Tensor,
                    generator: Optional[torch.Generator],
                    w: Optional[torch.Tensor] = None,
                    ctf: Optional[torch.Tensor] = None):
        """This rank's (-elbo, log_p, kl) over its own rows of its data
        shard's rows y (and their weights w and CTF kernels ctf): means, or
        sums weighted by w; the posterior grid-sharded over the model axis
        (compute_elbo(sp=...); targetvae_tpu/train/loop.py::_loss_fn_sp).
        The data row's generator: the shared one on a single data row, so
        that the float32 step samples as the unsharded step; else one seeded
        from it, folded with the data index."""
        mesh = self._mesh
        b = y.shape[0]
        if b % mesh.model:
            raise ValueError(f"a batch of {b} does not split over "
                             f"{mesh.model} ranks")
        b_l = b // mesh.model
        rows = slice(mesh.rank * b_l, (mesh.rank + 1) * b_l)
        if generator is not None and mesh.data > 1:
            generator = torch.Generator().manual_seed(
                self._rank_seed(generator))
        elbo, log_p, kl = compute_elbo(
            params, self.model.cfg, self._x_coord, y[rows], generator,
            compute_dtype=self.compute_dtype,
            row_weights=None if w is None else w[rows],
            ctf=None if ctf is None else ctf[rows], sp=mesh.group)
        return -elbo, log_p, kl

    def _objective(self, params: dict, y: torch.Tensor,
                   generator: Optional[torch.Generator],
                   w: Optional[torch.Tensor] = None,
                   ctf: Optional[torch.Tensor] = None):
        """(the scalar this rank differentiates, the (3,) metrics [elbo,
        log_p, kl] of the whole batch); y, w and ctf are this rank's data
        shard's rows. Over ranks an unweighted objective is this rank's
        means divided by the number of ranks, and a weighted one its
        weighted sums (the weights sum to 1 over the global batch), so
        that the ranks' objectives add up to the batch's (the JAX
        package's pmean against psum); the metrics are all-reduced."""
        if self._mesh is None:
            neg_elbo, log_p, kl = self._loss_fn(params, y, generator, w, ctf)
            return neg_elbo, torch.stack([-neg_elbo, log_p, kl]).detach()
        loss_fn = self._loss_fn_sp if self.cfg.sp else self._loss_fn_dp
        loss, log_p, kl = loss_fn(params, y, generator, w, ctf)
        div = 1 if w is not None else self._mesh.size
        metrics = torch.stack([-loss, log_p, kl]).detach() / div
        dist.all_reduce(metrics)
        return loss / div, metrics

    def on_device(self, y) -> Optional[torch.Tensor]:
        """y (an array or tensor) as float32 on the model's device, without
        a copy where it already is; a bf16 batch (or bf16 CTF kernels, the
        host feed's bf16 wire) is upcast, as the JAX loss does. None stays
        None."""
        if y is None:
            return None
        return torch.as_tensor(y).to(self.model.device, torch.float32)

    def _step(self, state: TrainState, y, w=None, ctf=None
              ) -> Tuple[TrainState, torch.Tensor]:
        """One Adam step on this rank's rows y (weights w, CTF kernels
        ctf). Under tensor parallelism Adam steps this rank's shards, which
        the ranks of its data row then gather into the whole parameters."""
        with span("tvae.step"):
            state.optimizer.zero_grad(set_to_none=True)
            state.model.zero_grad(set_to_none=True)
            with span("tvae.forward"):
                objective, metrics = self._objective(
                    state.model.params(), self.on_device(y), state.generator,
                    self.on_device(w), self.on_device(ctf))
            with span("tvae.backward"):
                objective.backward()
                if self._mesh is not None:
                    self._mesh.all_reduce_grads(state.model.parameters())
            with span("tvae.optimizer"):
                if state.shards is not None:
                    state.shards.take_grads()
                state.optimizer.step()
                if state.shards is not None:
                    state.shards.gather_params()
        state.step += 1
        return state, metrics

    def _eval(self, state: TrainState, y, generator, w=None, ctf=None
              ) -> torch.Tensor:
        with torch.inference_mode():
            return self._objective(state.model.params(), self.on_device(y),
                                   generator, self.on_device(w),
                                   self.on_device(ctf))[1]

    def _mine(self, *vs):
        """This rank's rows of whole-batch arrays or tensors (None stays
        None)."""
        if self._mesh is None:
            return vs
        rows = self.batch_rows(vs[0].shape[0])
        return tuple(None if v is None else v[rows] for v in vs)

    def train_step(self, state: TrainState, y,
                   row_weights: Optional[torch.Tensor] = None,
                   ctf=None) -> Tuple[TrainState, torch.Tensor]:
        """One Adam step on the batch y (B, H, W, C) with its CTF kernels
        ctf (B, kc, kc) where given, noise from state.generator (None:
        deterministic); row_weights (B,) turns the batch means into weighted
        sums. Returns (state, metrics) with
        metrics the (3,) tensor [elbo, log_p, kl] on the model's device;
        reading it waits for the step. The parameters, Adam's moments and
        state.step are updated in place. Over ranks every rank passes the
        same whole batch (B a multiple of dp * tp) and gets the same
        metrics and parameters."""
        return self._step(state, *self._mine(y, row_weights, ctf))

    def eval_step(self, state: TrainState, y,
                  generator: Optional[torch.Generator] = None,
                  row_weights: Optional[torch.Tensor] = None,
                  ctf=None) -> torch.Tensor:
        """[elbo, log_p, kl] of the batch y (with its CTF kernels ctf where
        given), no gradient; noise from `generator` (None: deterministic).
        Over ranks as train_step."""
        y, row_weights, ctf = self._mine(y, row_weights, ctf)
        return self._eval(state, y, generator, row_weights, ctf)

    # batches per chunk whose metrics are read together when a progress
    # callback wants mid-epoch reports (and always in a streamed epoch)
    progress_chunk = 50

    def train_epoch(self, state: TrainState, data, ctf=None, progress=None,
                    ) -> Tuple[TrainState, Tuple[float, float, float]]:
        """One epoch over `data` (N, H, W, C) and its CTF kernels `ctf` (N,
        kc, kc) where given. Returns (state, (elbo, gen_loss, kl)) with
        gen_loss = -log_p, matching the reference's reported Error.

        The order is torch.randperm(N) drawn from state.generator (a state
        without one keeps the data's order); N // B full batches, then the
        tail as one batch of N % B (over ranks padded with zero-weight rows
        to a multiple of them). Each rank takes its rows of each batch.
        progress: optional callback(images_seen, elbo, gen_loss, kl) called
        with the reference's streaming-mean accumulators
        (train_mnist.py:326-345) every `progress_chunk` batches. A chunk's
        metrics are read once the next chunk's steps are queued."""
        with span("tvae.epoch"):
            data, ctf = self.on_device(data), self.on_device(ctf)
            n = data.shape[0]
            b = self._epoch_batch(n)
            g = state.generator
            perm = (torch.arange(n) if g is None
                    else torch.randperm(n, generator=g, device=g.device)
                    ).to(data.device)
            n_full = n // b
            mine = self.batch_rows(b) if n_full else None
            chunk = n_full if progress is None else min(self.progress_chunk,
                                                        n_full)
            metrics, weights = [], []
            pending, block = None, []
            for i in range(n_full):
                idx = perm[i * b:(i + 1) * b][mine]
                state, m = self._step(state, data.index_select(0, idx),
                                      ctf=_rows(ctf, idx))
                block.append(m)
                if len(block) == chunk or i == n_full - 1:
                    if pending is not None:    # waits for the PREVIOUS chunk
                        _collect(pending, [float(b)] * len(pending),
                                 metrics, weights)
                        if progress is not None:
                            progress(int(sum(weights)),
                                     *_streaming_means(metrics, weights))
                    pending, block = torch.stack(block), []
            if pending is not None:
                _collect(pending, [float(b)] * len(pending), metrics,
                         weights)

            rem = n - n_full * b
            if rem:
                tail, w = self._pad_tail(perm[n_full * b:], rem)
                tail, w = self._mine(tail, w)
                state, m = self._step(state, data.index_select(0, tail), w,
                                      _rows(ctf, tail))
                _collect(m[None], [float(rem)], metrics, weights)
            return state, _weighted_mean(np.concatenate(metrics), weights)

    def _epoch_batch(self, n: int) -> int:
        """An epoch's batch size over n images: B, or n where n < B (the
        JAX package's min(B, n)); over ranks that do not divide n < B, B,
        so that the whole split runs as one tail padded over them."""
        b = min(self.batch, n)
        if self._mesh is not None and b % self._mesh.size:
            return self.batch
        return b

    def _pad_tail(self, tail: torch.Tensor, rem: int):
        """Pad a ragged tail's index vector to the next multiple of the
        ranks by repeating its first row with ZERO weight, the real rows
        carrying 1/rem (their loss, gradients and metrics equal the
        unpadded tail's batch means). With no mesh: (tail, None), the tail
        runs as a smaller batch. (The host feed pads by wrapping around
        instead; both pads weigh zero.)"""
        pad = 0 if self._mesh is None else (-rem) % self._mesh.size
        if not pad:
            return tail, None
        tail = torch.cat([tail, tail[:1].expand(pad)])
        w = torch.cat([torch.full((rem,), 1.0 / rem), torch.zeros(pad)])
        return tail, w.to(tail.device)

    def eval_epoch(self, state: TrainState, data, ctf=None, seed: int = 0,
                   ) -> Tuple[float, float, float]:
        """(elbo, gen_loss, kl) over `data` (and its CTF kernels `ctf`) in
        order, batches of B and the tail, sampled with a generator seeded
        `seed`. Each rank takes its rows of each batch."""
        data, ctf = self.on_device(data), self.on_device(ctf)
        n = data.shape[0]
        b = self._epoch_batch(n)
        n_full = n // b
        gen = torch.Generator().manual_seed(seed)
        out = []
        for i in range(n_full):
            y, c = self._mine(data[i * b:(i + 1) * b],
                              None if ctf is None else ctf[i * b:(i + 1) * b])
            out.append(self._eval(state, y, gen, ctf=c))
        weights = [float(b)] * n_full
        rem = n - n_full * b
        if rem:
            tail, w = self._pad_tail(
                torch.arange(n_full * b, n, device=data.device), rem)
            tail, w = self._mine(tail, w)
            out.append(self._eval(state, data.index_select(0, tail), gen,
                                  w, _rows(ctf, tail)))
            weights.append(float(rem))
        return _weighted_mean(torch.stack(out).cpu().numpy(), weights)

    def _stream_rows(self, y) -> int:
        """A bare (y, ctf) pair's count of global rows: y holds this rank's
        rows (batch_rows)."""
        return int(y.shape[0]) * (1 if self._mesh is None
                                  else self._row_shards())

    def train_epoch_stream(self, state: TrainState, batches, progress=None,
                           ) -> Tuple[TrainState, Tuple[float, float, float]]:
        """One epoch over an iterator of StreamBatch(y, ctf, w, n_real)
        batches (data/pipeline.HostDataPipeline, made with
        rows=batch_rows(B) over ranks) or bare (y, ctf) pairs of this
        rank's rows: the streaming path for datasets that do not fit on the
        card. Every batch has the fixed batch size (the tail arrives padded
        with zero-weight rows), so the whole epoch runs one step shape and,
        over ranks, splits evenly. Each step's metrics weigh its n_real.

        progress: optional callback(images_seen, elbo, gen_loss, kl) with
        the reference's streaming means, called every progress_chunk
        batches with the metrics one chunk behind the steps being queued,
        as train_epoch reads them (the JAX package calls it after every
        batch; reading then would make the host wait for each step: a
        deviation of cadence only)."""
        with span("tvae.epoch"):
            metrics, weights = [], []
            pending, block = None, ([], [])
            for item in batches:
                y, ctf, w, n_real = _unpack_stream_batch(item)
                if n_real is None:
                    n_real = self._stream_rows(y)
                state, m = self._step(state, y, w, ctf)
                block[0].append(m)
                block[1].append(float(n_real))
                if len(block[0]) == self.progress_chunk:
                    if pending is not None:    # waits for the PREVIOUS chunk
                        _collect(*pending, metrics, weights)
                        if progress is not None:
                            progress(int(sum(weights)),
                                     *_streaming_means(metrics, weights))
                    pending = (torch.stack(block[0]), block[1])
                    block = ([], [])
            if pending is not None:
                _collect(*pending, metrics, weights)
            if block[0]:
                _collect(torch.stack(block[0]), block[1], metrics, weights)
            return state, _weighted_mean(np.concatenate(metrics), weights)

    def eval_epoch_stream(self, state: TrainState, batches,
                          seed: Optional[int] = 0,
                          ) -> Tuple[float, float, float]:
        """(elbo, gen_loss, kl) over an iterator of StreamBatch batches
        (data/pipeline.HostDataPipeline with shuffle=False): the streaming
        analogue of eval_epoch, sampled with a generator seeded `seed` (None:
        no noise). Same fixed-size, zero-weight-tail contract as
        train_epoch_stream."""
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        out, weights = [], []
        for item in batches:
            y, ctf, w, n_real = _unpack_stream_batch(item)
            out.append(self._eval(state, y, gen, w, ctf))
            weights.append(float(self._stream_rows(y) if n_real is None
                                 else n_real))
        return _weighted_mean(torch.stack(out).cpu().numpy(), weights)


def _unpack_stream_batch(b) -> Tuple:
    """(y, ctf, w, n_real) from a StreamBatch (data/pipeline) or a bare
    (y, ctf) pair (n_real None): the one place the streamed-batch contract
    is decoded."""
    if len(b) == 2:
        y, ctf = b
        return y, ctf, None, None
    y, ctf, w, n_real = b
    return y, ctf, w, int(n_real)


def _rows(v: Optional[torch.Tensor], idx: torch.Tensor
          ) -> Optional[torch.Tensor]:
    """The rows idx of v (the CTF kernels), or None without v."""
    return None if v is None else v.index_select(0, idx)


def _collect(pending: torch.Tensor, step_weights: list, metrics: list,
             weights: list) -> None:
    """Read a (k, 3) block of step metrics to the host, each step weighing
    its count of real images."""
    with span("tvae.collect"):
        metrics.append(pending.cpu().numpy())
    weights += step_weights


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
