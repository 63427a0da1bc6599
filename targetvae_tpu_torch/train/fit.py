"""The shared outer training loop (epochs, early stopping, LR plateau,
checkpoints, resume, profiling) used by the training CLIs (mirror of
targetvae_tpu/train/fit.py).

Replicates the reference main() epoch loop behavior (train_mnist.py:626-684):
train epoch -> test eval -> EarlyStopping(patience 20, delta 1e-4) with
best-model save -> ReduceLROnPlateau(max, 0.5, patience 9, 1e-4 abs) ->
periodic epoch snapshots every save_interval epochs. Adds what the reference
lacks: a full resume checkpoint (optimizer state + generator + controller
state), per-epoch throughput logging, and a torch.profiler trace of one
epoch. Runs on one device: the mesh, SP and host-stream branches of the JAX
package's fit are not ported yet (ROADMAP.md, queue 1, items 22-24).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ..models.targetvae import TargetVAE
from ..utils.config import TrainConfig
from .checkpoint import AsyncCheckpointer, load_train_state, save_model_pair
from .logging import RunLogger
from .loop import Trainer
from .schedule import EarlyStopping, ReduceLROnPlateau
from .state import set_learning_rate

RESUME_FILE = "training_state.sav"


def _refuse_unported(train_cfg: TrainConfig) -> None:
    """What fit does not run yet; the Trainer refuses the host feed, dp > 1
    and tp > 1 itself."""
    if train_cfg.sp:
        raise NotImplementedError(
            "--sp: fit on grid-sharded ranks (with their ragged tails) is "
            "not ported yet (ROADMAP.md, queue 1, item 24)")


def fit(model: TargetVAE, train_cfg: TrainConfig, logger: RunLogger,
        y_train, y_test, ctf_train=None, ctf_test=None,
        num_epochs: Optional[int] = None,
        resume_dir: Optional[str] = None,
        profile_dir: Optional[str] = None):
    """Returns the final TrainState. y_train, y_test: (N, H, W, C) arrays or
    tensors, and ctf_train, ctf_test: their (N, kc, kc) CTF kernels or None,
    put on the model's device once."""
    _refuse_unported(train_cfg)
    trainer = Trainer(model, train_cfg)
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

    y_train, y_test = trainer.on_device(y_train), trainer.on_device(y_test)
    ctf_train = trainer.on_device(ctf_train)
    ctf_test = trainer.on_device(ctf_test)

    stopper.save_fn = lambda: save_model_pair(
        logger.path_prefix, state.model.params(), model.cfg,
        step=int(state.step))
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

        # per-chunk streaming-mean progress, the reference's \r stderr line
        # (train_mnist.py:340-343)
        def report(c, elbo_m, err_m, kl_m, _epoch=epoch):
            logger.progress(f"# [{_epoch + 1}/{num_epochs}] training "
                            f"{c / n_train:.1%}, ELBO={elbo_m:.5f}, "
                            f"Error={err_m:.5f}, KL={kl_m:.5f}")
        state, (elbo, gen_loss, kl) = trainer.train_epoch(
            state, y_train, ctf_train, progress=report)
        dt = time.time() - t0
        logger.progress(" " * 100)     # clear the \r progress line
        logger.epoch(epoch + 1, "train", elbo, gen_loss, kl)
        logger.progress(f"# epoch {epoch + 1}: {dt:.2f}s, "
                        f"{n_train / dt:.0f} images/sec")

        elbo_t, gen_loss_t, kl_t = trainer.eval_epoch(state, y_test, ctf_test,
                                                      seed=epoch)
        logger.epoch(epoch + 1, "test", elbo_t, gen_loss_t, kl_t)

        if profiler is not None and epoch == start_epoch + 1:
            profiler.stop()
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

        ckpt.save(
            os.path.join(logger.path_prefix, RESUME_FILE), state, model.cfg,
            host_state={
                "epoch": epoch + 1, "lr": scheduler.lr,
                "sched_best": scheduler.best, "sched_bad": scheduler.num_bad,
                "early_best": stopper.max_elbo,
                "early_counter": stopper.counter,
            })

        if stopper.early_stop:
            logger.line("*** Early stopping ***")
            break

        if (epoch + 1) % train_cfg.save_interval == 0:
            suffix = "_epoch" + str(epoch + 1).zfill(digits)
            save_model_pair(logger.path_prefix, state.model.params(),
                            model.cfg, step=int(state.step), suffix=suffix)

    ckpt.wait()
    return state
