"""The ranks' side of the port's multi-rank CPU tests (tests/test_torch_port_
{dp,fit,sp,train}.py): functions that run_local starts on gloo ranks, each
fn(rank, world, *args). They import only torch, numpy and the port (the
ranks are spawned processes that import this module by name, and JAX stays
in the test process); inputs arrive as arguments, made there from seeds.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.data.pipeline import HostDataPipeline
from targetvae_tpu_torch.train import (NullLogger, RunLogger, Trainer,
                                       create_train_state, fit)
from targetvae_tpu_torch.utils.config import TrainConfig


def _grads(model) -> dict:
    return {n: p.grad.detach().numpy().copy()
            for n, p in model.named_parameters()}


def _clone(tree):
    """A copy of a params dict (training updates its tensors in place)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def _params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _logger(rank: int, root: str, name: str):
    """A run logger on rank 0 only, as the train CLIs make it."""
    return RunLogger(root, name) if rank == 0 else NullLogger()


def _fit(rank, cfg, train_cfg, root, name, data, ctf=(None, None), **kw):
    lg = _logger(rank, root, name)
    try:
        return fit(TargetVAE(cfg, device="cpu"), train_cfg, lg, *data,
                   ctf_train=ctf[0], ctf_test=ctf[1], **kw)
    finally:
        lg.close()


def fit_one_epoch(rank, world, cfg_json, train_kw, root, data):
    """fit for one epoch under TrainConfig(**train_kw) over the ranks: the
    state's step and, on rank 0, the run directory's train_log.txt."""
    cfg = ModelConfig.from_json(cfg_json)
    state = _fit(rank, cfg, TrainConfig(num_epochs=1, **train_kw), root,
                 "run", data)
    log = None
    if rank == 0:
        log = open(os.path.join(root, "run", "train_log.txt")).read()
    return {"step": state.step, "log": log, "params": _params(state.model)}


def dp_trainer_step(rank, world, cfg_json, y):
    """Trainer(dp=world) on the CPU without a device named: the device and
    one sampled step's metrics."""
    trainer = Trainer(ModelConfig.from_json(cfg_json),
                      TrainConfig(dp=world, minibatch_size=len(y)),
                      device="cpu")
    state = trainer.init_state(0)
    state, m = trainer.train_step(state, y)
    return {"device": str(trainer.model.device), "metrics": m.numpy(),
            "step": state.step}


def dp_work(rank, world, inp):
    """test_torch_port_dp.py's dp = 2 scenarios, in one spawn."""
    out = {}
    cfg = ModelConfig.from_json(inp["cfg"])
    lr = inp["lr"]

    # one deterministic f32 step on the JAX package's parameters
    trainer = Trainer(cfg, TrainConfig(learning_rate=lr, dp=world),
                      device="cpu")
    trainer.model.load_params(_clone(inp["params"]))
    state = create_train_state(trainer.model, lr, None)
    _, m = trainer.train_step(state, inp["y"])
    out["step"] = {"metrics": m.numpy(), "grads": _grads(trainer.model)}

    # a ragged tail of 5 padded over the ranks to 6 (zero-weight first row)
    tail, w = trainer._pad_tail(torch.arange(5), 5)
    trainer.model.load_params(_clone(inp["params"]))
    state = create_train_state(trainer.model, lr, None)
    _, m = trainer.train_step(state, inp["y"][tail.numpy()], w)
    out["tail"] = {"metrics": m.numpy(), "grads": _grads(trainer.model),
                   "w": w.numpy(), "rows": tail.numpy()}

    # a ragged resident epoch (10 images, B = 4: two batches and a tail of
    # 2), deterministic, in the data's order
    tr = Trainer(cfg, TrainConfig(learning_rate=lr, dp=world,
                                  minibatch_size=4), device="cpu")
    state = tr.init_state(0)
    state.generator = None
    state, means = tr.train_epoch(state, inp["epoch_y"])
    out["epoch"] = {"means": means, "params": _params(tr.model),
                    "steps": state.step}
    # a split smaller than a batch (3 images at B = 4): one padded tail
    state = tr.init_state(0)
    state.generator = None
    state, means = tr.train_epoch(state, inp["epoch_y"][:3])
    out["small"] = {"means": means, "params": _params(tr.model),
                    "steps": state.step}

    # a streamed epoch: each rank gathers its rows of every batch
    tr = Trainer(cfg, TrainConfig(learning_rate=lr, dp=world,
                                  minibatch_size=4), device="cpu")
    state = tr.init_state(0)
    state.generator = None
    pipe = HostDataPipeline(inp["epoch_y"], batch_size=4, seed=3,
                            device="cpu", rows=tr.batch_rows(4))
    shapes = [tuple(b.y.shape) for b in pipe.epoch(0)]
    state, means = tr.train_epoch_stream(state, pipe.epoch(0))
    out["stream"] = {"means": means, "params": _params(tr.model),
                     "shapes": shapes}

    # SP (tp = 2, bf16) with CTF kernels and a zero-weight padded tail
    sp_cfg = ModelConfig.from_json(inp["sp_cfg"])
    tr = Trainer(sp_cfg, TrainConfig(learning_rate=lr, tp=world, sp=True,
                                     compute_dtype="bfloat16"), device="cpu")
    state = tr.init_state(0)
    state.generator = None
    sp = inp["sp"]
    _, m = tr.train_step(state, sp["y"], torch.from_numpy(sp["w"]),
                         sp["ctf"])
    out["sp"] = {"metrics": m.numpy(), "params": _params(tr.model),
                 "grads": _grads(tr.model)}

    # fit over the ranks, host-streamed: 2 epochs at once, and 1 epoch then
    # a resume for 1 more
    root = inp["root"]
    train = TrainConfig(learning_rate=lr, dp=world, minibatch_size=4,
                        num_epochs=2, host_stream=True)
    full = _fit(rank, cfg, train, os.path.join(root, "full"), "run",
                inp["fit_data"])
    _fit(rank, cfg, train, os.path.join(root, "half"), "run",
         inp["fit_data"], num_epochs=1)
    resumed = _fit(rank, cfg, train, os.path.join(root, "resumed"), "run",
                   inp["fit_data"],
                   resume_dir=os.path.join(root, "half", "run"))
    out["fit"] = {"full": _params(full.model), "resumed":
                  _params(resumed.model), "steps": (full.step, resumed.step)}
    return out


def dp_sp_work(rank, world, cfg_json, y, lr, steps):
    """dp = 2 x tp = 2 SP (bf16) on 4 ranks: one deterministic step's
    metrics and parameters, then `steps` sampled steps' metrics and the
    parameters after them."""
    trainer = Trainer(ModelConfig.from_json(cfg_json),
                      TrainConfig(learning_rate=lr, dp=2, tp=world // 2,
                                  sp=True, compute_dtype="bfloat16",
                                  minibatch_size=len(y)), device="cpu")
    state = trainer.init_state(0)
    generator, state.generator = state.generator, None
    state, m = trainer.train_step(state, y)
    out = {"det_metrics": m.numpy(), "det_grads": _grads(trainer.model),
           "mesh": (trainer.mesh.data_index, trainer.mesh.rank)}
    state.generator = generator
    out["sampled"] = np.stack([trainer.train_step(state, y)[1].numpy()
                               for _ in range(steps)])
    out["params"] = _params(trainer.model)
    return out


def sp_stream_epoch(trainer: Trainer, state, images, batch: int):
    """A host-streamed epoch of the SP trainer (its rows of each batch of a
    pipeline over `images`): the epoch's means."""
    pipe = HostDataPipeline(images, batch_size=batch, seed=1, device="cpu",
                            rows=trainer.batch_rows(batch))
    return trainer.train_epoch_stream(state, pipe.epoch(0))[1]
