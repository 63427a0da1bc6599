"""The ranks' side of the port's multi-rank CPU tests (tests/test_torch_port_
{dp,fit,sp,sp_modes,tp,train}.py): functions that run_local starts on gloo
ranks, each fn(rank, world, *args). They import only torch, numpy and the
port (the ranks are spawned processes that import this module by name, and
JAX stays in the test process); inputs arrive as arguments, made there from
seeds.
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


def _moments(state) -> dict:
    """Adam's moments of the optimizer's parameters (shards under TP), by
    position."""
    return {i: {k: v.detach().numpy().copy()
                for k, v in state.optimizer.state[p].items()
                if k in ("exp_avg", "exp_avg_sq")}
            for i, p in enumerate(state.optimizer.param_groups[0]["params"])
            if state.optimizer.state.get(p)}


def tp_work(rank, world, inp):
    """test_torch_port_tp.py's dp = 2 x tp = 2 scenarios, in one spawn."""
    from targetvae_tpu_torch.parallel.pjit import shard_state
    from targetvae_tpu_torch.train import load_train_state, save_train_state
    from targetvae_tpu_torch.train.state import make_optimizer
    out = {}
    cfg = ModelConfig.from_json(inp["cfg"])
    lr = inp["lr"]
    make = lambda **kw: Trainer(cfg, TrainConfig(
        learning_rate=lr, dp=2, tp=world // 2, minibatch_size=8, **kw),
        device="cpu")

    # one deterministic step on each tier from the JAX package's weights
    for tier in ("float32", "bfloat16"):
        tr = make(compute_dtype=None if tier == "float32" else tier)
        tr.model.load_params(_clone(inp["params"]))
        state = shard_state(create_train_state(tr.model, lr, None), tr.mesh)
        before = _params(tr.model)
        state, m = tr.train_step(state, inp["y"])
        grads = _grads(tr.model)
        # Adam over the whole leaves on the same all-reduced gradients
        whole = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                 for n, v in before.items()}
        for n, p in whole.items():
            p.grad = torch.from_numpy(grads[n])
        make_optimizer(list(whole.values()), lr).step()
        out[tier] = {"metrics": m.numpy(), "grads": grads,
                     "params": _params(tr.model),
                     "replicated_adam": {n: p.detach().numpy().copy()
                                         for n, p in whole.items()},
                     "bytes": state.shards.nbytes(state.optimizer),
                     "rows": tr.batch_rows(8),
                     "mesh": (tr.mesh.data_index, tr.mesh.rank)}

    # a ragged epoch of 2 B - 1 rows: a full batch and a tail of 7 padded
    # to 8, deterministic, at lr 0 and at lr
    for key, rate in (("ragged_lr0", 0.0), ("ragged", lr)):
        tr = Trainer(cfg, TrainConfig(learning_rate=rate, dp=2,
                                      tp=world // 2, minibatch_size=8),
                     device="cpu")
        state = tr.init_state(0)
        state.generator = None
        state, means = tr.train_epoch(state, inp["epoch_y"])
        out[key] = {"means": means, "steps": state.step,
                    "params": _params(tr.model)}

    # checkpoints: 2 sampled steps at once against 1, a save, a load into
    # a fresh sharded state and 1 more; a one-process file loaded sharded
    root = inp["root"]
    tr = make()
    state = tr.init_state(0)
    for _ in range(2):
        state, _ = tr.train_step(state, inp["y"])
    full = {"params": _params(tr.model), "moments": _moments(state)}
    state = tr.init_state(0)
    state, _ = tr.train_step(state, inp["y"])
    save_train_state(os.path.join(root, "tp.sav"), state, cfg,
                     {"epoch": 1})
    saved = _params(tr.model)
    tr2 = make()
    state2, _, host = load_train_state(os.path.join(root, "tp.sav"),
                                       tr2.init_state(5))
    loaded = _params(tr2.model)
    state2, _ = tr2.train_step(state2, inp["y"])
    out["resume"] = {"full": full, "saved": saved, "loaded": loaded,
                     "resumed": {"params": _params(tr2.model),
                                 "moments": _moments(state2)},
                     "host": host, "step": state2.step}
    tr3 = make()
    state3, _, _ = load_train_state(inp["one_process_file"],
                                    tr3.init_state(5))
    opt = state3.optimizer
    out["one_process"] = {
        "params": _params(tr3.model), "step": state3.step,
        "shards": {leaf.path: (leaf.axis, leaf.shard.detach().numpy().copy(),
                               {k: v.numpy().copy() for k, v in
                                opt.state[leaf.shard].items()
                                if k != "step"})
                   for leaf in state3.shards.leaves}}
    return out


def sp_elbo(params, cfg, y, generator, compute_dtype, group):
    """compute_elbo(sp=group) on this rank's rows y under a fresh copy of
    params: its rows' [elbo, log_p, kl] and the gradients of the group's
    batch mean of -elbo, all-reduced over the group (the ranks' mean
    metrics and summed gradients)."""
    import torch.distributed as dist
    from targetvae_tpu_torch.losses.elbo import compute_elbo
    model = TargetVAE(cfg, device="cpu")
    model.load_params(_clone(params))
    t = dist.get_world_size(group)
    out = compute_elbo(model.params(), cfg, model.base_grid(), y, generator,
                       compute_dtype=compute_dtype, sp=group)
    (-out[0] / t).backward()
    metrics = torch.stack(out).detach() / t
    dist.all_reduce(metrics, group=group)
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        dist.all_reduce(g, group=group)
        grads[n] = g.numpy().copy()
    return {"metrics": metrics.numpy(), "grads": grads}


def sp_modes_work(rank, world, inp):
    """test_torch_port_sp_modes.py's grid-sharded cases, in one spawn of 7
    ranks: each case runs on the first T ranks (a group of its own)."""
    import torch.distributed as dist
    from targetvae_tpu_torch.parallel.grid_softmax import (
        sharded_gumbel_softmax, sharded_log_softmax, sharded_weighted_moments)
    groups = {t: dist.new_group(list(range(t))) for t in (2, 3, 5, 7)}
    out = {}
    for key, case in inp["cases"].items():
        t = case["ranks"]
        if rank >= t:
            continue
        cfg = ModelConfig.from_json(case["cfg"])
        y = case["y"]
        b = len(y) // t
        gen = (None if case["seed"] is None
               else torch.Generator().manual_seed(case["seed"]))
        out[key] = sp_elbo(inp["params"][case["params"]], cfg,
                           torch.from_numpy(y[rank * b:(rank + 1) * b]), gen,
                           torch.bfloat16 if case["bf16"] else None,
                           groups[t])
    if rank < 2:
        attn, noise, z = (torch.from_numpy(v) for v in inp["softmax"])
        c = attn.shape[1] // 2
        cut = lambda v: v[:, rank * c:(rank + 1) * c]
        a = sharded_gumbel_softmax(cut(attn), cut(noise), groups[2])
        out["softmax"] = {
            "q": sharded_log_softmax(cut(attn), groups[2]).numpy(),
            "a": a.numpy(),
            "ez": sharded_weighted_moments(a, cut(z), groups[2]).numpy()}
    return out
