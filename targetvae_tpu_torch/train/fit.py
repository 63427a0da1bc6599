"""The shared outer training loop (epochs, early stopping, LR plateau,
checkpoints, resume, profiling) used by the training CLIs (mirror of
targetvae_tpu/train/fit.py).

Replicates the reference main() epoch loop behavior (train_mnist.py:626-684):
train epoch -> test eval -> EarlyStopping(patience 20, delta 1e-4) with
best-model save -> ReduceLROnPlateau(max, 0.5, patience 9, 1e-4 abs) ->
periodic epoch snapshots every save_interval epochs. Adds what the reference
lacks: a full resume checkpoint (optimizer state + generator + controller
state), per-epoch throughput logging, and a torch.profiler trace of one
epoch. As the JAX package's fit it runs on one device or over ranks (dp
data shards; tp parameter shards, or grid shards with sp; only rank 0
writes), with both splits on the card or streamed from host RAM
(host_stream, stream_bf16).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..data.pipeline import HostDataPipeline
from ..models.targetvae import TargetVAE
from ..utils.config import TrainConfig
from .checkpoint import AsyncCheckpointer, load_train_state, save_model_pair
from .logging import RunLogger
from .loop import Trainer, check_train_config
from .schedule import EarlyStopping, ReduceLROnPlateau
from .state import set_learning_rate

RESUME_FILE = "training_state.sav"


def fit(model: TargetVAE, train_cfg: TrainConfig, logger: RunLogger,
        y_train, y_test, ctf_train=None, ctf_test=None,
        num_epochs: Optional[int] = None,
        resume_dir: Optional[str] = None,
        profile_dir: Optional[str] = None):
    """Returns the final TrainState. y_train, y_test: (N, H, W, C) arrays or
    tensors, and ctf_train, ctf_test: their (N, kc, kc) CTF kernels or None,
    put on the model's device once, or, with host_stream, streamed from
    host RAM. Over ranks (dp * tp > 1, an initialised process group) every
    rank calls fit with the same data; only rank 0 writes (the models, the
    snapshots, the resume file; the other ranks are given a NullLogger),
    every rank reads the resume file."""
    if train_cfg.sp:
        if train_cfg.tp <= 1:
            raise SystemExit("--sp shards the posterior grid over the "
                             "'model' mesh axis; it requires --tp > 1")
        if model.cfg.encoder.mode not in ("B", "C"):
            raise SystemExit("--sp needs an attention posterior "
                             "(t_inf=attention)")
    check_train_config(model.cfg, train_cfg)
    n_mesh = train_cfg.dp * train_cfg.tp
    if n_mesh > 1:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n_mesh != world:
            raise SystemExit(f"--dp {train_cfg.dp} x --tp {train_cfg.tp} "
                             f"needs {n_mesh} ranks, found {world}")
        if train_cfg.minibatch_size % train_cfg.dp:
            raise SystemExit(f"--minibatch-size {train_cfg.minibatch_size} "
                             f"must be divisible by --dp {train_cfg.dp}")
        if train_cfg.minibatch_size % n_mesh:
            raise SystemExit(f"--minibatch-size {train_cfg.minibatch_size} "
                             f"must be divisible by --dp {train_cfg.dp} x "
                             f"--tp {train_cfg.tp}")
    trainer = Trainer(model, train_cfg)
    mesh = trainer.mesh
    rank0 = mesh is None or dist.get_rank() == 0
    state = trainer.init_state(train_cfg.seed)
    num_epochs = num_epochs or train_cfg.num_epochs
    digits = len(str(num_epochs))

    scheduler = ReduceLROnPlateau(
        train_cfg.learning_rate, mode="max", factor=train_cfg.plateau_factor,
        patience=train_cfg.plateau_patience,
        threshold=train_cfg.plateau_threshold, min_lr=train_cfg.min_lr)
    stopper = EarlyStopping(patience=train_cfg.early_patience,
                            delta=train_cfg.early_delta)
    start_epoch = 0

    if resume_dir:
        ckpt = os.path.join(resume_dir, RESUME_FILE)
        state, _, host = load_train_state(ckpt, state, log=logger.line)
        start_epoch = int(host.get("epoch", 0))
        scheduler.lr = float(host.get("lr", scheduler.lr))
        scheduler.best = float(host.get("sched_best", scheduler.best))
        scheduler.num_bad = int(host.get("sched_bad", 0))
        stopper.max_elbo = float(host.get("early_best", stopper.max_elbo))
        stopper.counter = int(host.get("early_counter", 0))
        # the scheduler's float, not the file's float32 copy in opt_state
        state = set_learning_rate(state, scheduler.lr)
        logger.line(f"# resumed from {ckpt} at epoch {start_epoch}, "
                    f"lr {scheduler.lr:g}")
    if mesh is not None:
        logger.line(f"# mesh: data={train_cfg.dp} model={train_cfg.tp} "
                    f"({n_mesh} ranks, {dist.get_backend()} backend)")

    train_pipe = test_pipe = None
    if train_cfg.stream_bf16 and not train_cfg.host_stream:
        logger.line("# note: --stream-bf16 only affects --host-stream runs; "
                    "ignored (data is device-resident)")
    if train_cfg.host_stream:
        # a worker thread's shuffle, gather and pinned copy; neither split
        # ever lies whole on the card (the test split streams too: a
        # dataset that outgrows the card usually brings a test split that
        # does as well). Each rank gathers its rows of every batch.
        wire = "bfloat16" if train_cfg.stream_bf16 else None
        pipe = lambda y, c, shuffle: HostDataPipeline(
            _host(y), None if c is None else _host(c),
            batch_size=train_cfg.minibatch_size, seed=train_cfg.seed,
            device=model.device, shuffle=shuffle, wire_dtype=wire,
            rows=trainer.batch_rows(train_cfg.minibatch_size))
        train_pipe = pipe(y_train, ctf_train, True)
        test_pipe = pipe(y_test, ctf_test, False)
        logger.line(f"# host-streaming train data ({len(train_pipe)} "
                    f"images; test {len(test_pipe)})"
                    + (" (bf16 wire)" if wire else ""))
    else:
        y_train, y_test = trainer.on_device(y_train), trainer.on_device(y_test)
        ctf_train = trainer.on_device(ctf_train)
        ctf_test = trainer.on_device(ctf_test)

    def save_best():
        if rank0:
            save_model_pair(logger.path_prefix, state.model.params(),
                            model.cfg, step=int(state.step))
    stopper.save_fn = save_best
    ckpt = AsyncCheckpointer()   # resume saves never block the epoch loop

    n_train = int(y_train.shape[0])
    profiler = None

    for epoch in range(start_epoch, num_epochs):
        if profile_dir and epoch == start_epoch + 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if model.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()

        t0 = time.time()
        before = kernels.launch_counts()

        # per-chunk streaming-mean progress, the reference's \r stderr line
        # (train_mnist.py:340-343)
        def report(c, elbo_m, err_m, kl_m, _epoch=epoch):
            logger.progress(f"# [{_epoch + 1}/{num_epochs}] training "
                            f"{c / n_train:.1%}, ELBO={elbo_m:.5f}, "
                            f"Error={err_m:.5f}, KL={kl_m:.5f}")
        if train_pipe is not None:
            state, (elbo, gen_loss, kl) = trainer.train_epoch_stream(
                state, train_pipe.epoch(epoch), progress=report)
        else:
            state, (elbo, gen_loss, kl) = trainer.train_epoch(
                state, y_train, ctf_train, progress=report)
        dt = time.time() - t0
        logger.progress(" " * 100)     # clear the \r progress line
        logger.epoch(epoch + 1, "train", elbo, gen_loss, kl)
        logger.progress(f"# epoch {epoch + 1}: {dt:.2f}s, "
                        f"{n_train / dt:.0f} images/sec")

        if test_pipe is not None:
            elbo_t, gen_loss_t, kl_t = trainer.eval_epoch_stream(
                state, test_pipe.epoch(0), seed=epoch)
        else:
            elbo_t, gen_loss_t, kl_t = trainer.eval_epoch(
                state, y_test, ctf_test, seed=epoch)
        logger.epoch(epoch + 1, "test", elbo_t, gen_loss_t, kl_t)
        fallbacks = {k.split(".", 1)[1]: n - before[k]
                     for k, n in kernels.launch_counts().items()
                     if k.startswith("fallback.") and n > before[k]}
        if fallbacks:
            logger.line("# kernel fallbacks: " + ", ".join(
                f"{site} {n}" for site, n in fallbacks.items()))

        if profiler is not None and epoch == start_epoch + 1:
            profiler.stop()
            if rank0:
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(profile_dir,
                                                          "trace.json"))
            profiler = None
            logger.line(f"# profiler trace written to {profile_dir}")

        msg = stopper(elbo_t)
        logger.line(msg)
        logger.line("")

        prev_lr = scheduler.lr
        new_lr = scheduler.step(elbo_t)
        if new_lr != prev_lr:
            state = set_learning_rate(state, new_lr)
            logger.line(f"# reducing learning rate to {new_lr:g}")
        if mesh is not None:
            # the controllers decide from all-reduced metrics, so every rank
            # takes the same decisions; a rank that stopped or changed its
            # rate alone would leave its peers waiting in a collective
            mesh.agree([elbo, elbo_t, scheduler.lr, scheduler.best,
                        scheduler.num_bad, stopper.max_elbo, stopper.counter,
                        float(stopper.early_stop)], model.device)

        if rank0 or state.shards is not None:   # TP: every rank gathers
            ckpt.save(
                os.path.join(logger.path_prefix, RESUME_FILE) if rank0
                else None, state,
                model.cfg,
                host_state={
                    "epoch": epoch + 1, "lr": scheduler.lr,
                    "sched_best": scheduler.best,
                    "sched_bad": scheduler.num_bad,
                    "early_best": stopper.max_elbo,
                    "early_counter": stopper.counter,
                })

        if stopper.early_stop:
            logger.line("*** Early stopping ***")
            break

        if rank0 and (epoch + 1) % train_cfg.save_interval == 0:
            suffix = "_epoch" + str(epoch + 1).zfill(digits)
            save_model_pair(logger.path_prefix, state.model.params(),
                            model.cfg, step=int(state.step), suffix=suffix)

    ckpt.wait()
    if mesh is not None:
        dist.barrier()     # every rank returns once rank 0's files exist
    return state


def _host(x) -> np.ndarray:
    """An array or tensor as a host numpy array (the host feed's source)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
