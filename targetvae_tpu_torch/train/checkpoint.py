"""Checkpoint save/restore (mirror of targetvae_tpu/train/checkpoint.py), in
the JAX package's format, so that checkpoints move between the two packages
both ways.

Format: the magic line b"TVAE-TPU-CKPT-1\\n", then one msgpack map {config
json, step, params[, extra]} in flax's wire format (utils/msgpack.py gives
flax's bytes without flax). Parameters are written in the JAX package's
pytree names (utils/jax_params.py). `inference.sav` / `generator.sav` hold
the encoder's and the generator's sub-tree, the files the clustering CLIs
read.

The resume file adds under "extra":
- "opt_state": Adam in optax's state-dict layout for
  inject_hyperparams(adam): {"count", "hyperparams" {b1, b2, eps, eps_root,
  learning_rate}, "hyperparams_states", "inner_state" {"0": {"count", "mu",
  "nu"}, "1": {}}}, with mu and nu holding torch's exp_avg and exp_avg_sq
  (zeros for the Fourier buffers, which Adam here does not hold) and count
  the step;
- "key": a JAX PRNG key's uint32 data, which the JAX loader wraps;
- "host": the epoch loop's controller state;
- "torch_generator": this package's torch.Generator state (uint8), which the
  JAX loader ignores. A resume from a file without it (the JAX package's)
  draws fresh noise.

The optimizer updates the parameters and Adam's moments in place, so every
save copies what it writes to the host before it returns; AsyncCheckpointer
writes only the bytes on its thread.

A tensor-parallel state (state.shards, parallel/pjit.py) is saved whole:
every rank calls the save, the ranks of each data row gather Adam's moment
shards, and rank 0 alone writes, in the same format; a file loads into a
sharded state by cutting each rank's shards from the whole arrays. So a TP
run's checkpoint loads on one process (either package), and one process's
loads sharded.
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import msgpack
from ..utils.config import ModelConfig
from .state import TrainState, set_learning_rate

_MAGIC = b"TVAE-TPU-CKPT-1\n"
GENERATOR_KEY = "torch_generator"


def _tree_map(fn, tree):
    """fn over the leaves of nested dicts and lists; None stays."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def _to_host(tree):
    """The JAX package's _to_host: every leaf an ndarray, tensors copied to
    the host."""
    return _tree_map(lambda x: x.detach().to("cpu", copy=True).numpy()
                     if torch.is_tensor(x) else np.asarray(x), tree)


def _write(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(blob)
    os.replace(tmp, path)


def _payload(params: Any, cfg: ModelConfig, step: int,
             extra: Optional[dict]) -> dict:
    payload = {"config": cfg.to_json(), "step": step,
               "params": _to_host(params)}
    if extra is not None:
        payload["extra"] = _to_host(extra)
    return payload


def save_checkpoint(path: str, params: Any, cfg: ModelConfig,
                    step: int = 0, extra: Optional[dict] = None) -> None:
    """params: the nested dict of TargetVAE.params() (tensors) or the JAX
    package's pytree (numpy)."""
    _write(path, msgpack.packb(_payload(params, cfg, step, extra)))


def load_checkpoint(path: str) -> Tuple[Any, ModelConfig, dict]:
    """Returns (params, config, payload), params with numpy leaves
    (utils/jax_params.py::params_from_jax makes them tensors)."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            raise ValueError(f"{path} is not a targetvae_tpu checkpoint")
        payload = msgpack.unpackb(f.read())
    cfg = ModelConfig.from_json(payload["config"])
    return payload["params"], cfg, payload


# ---- Adam <-> optax's state dict ----

def _state_dict(tree):
    """flax.serialization.to_state_dict of a params tree: lists become maps
    keyed "0", "1", ..."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def _leaves(tree, sd, out: list) -> list:
    """(template leaf, state-dict leaf) pairs of a params tree and its
    state dict, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _leaves(v, sd[str(k)], out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _leaves(v, sd[str(i)], out)
    else:
        out.append((tree, sd))
    return out


def _moments(state: TrainState, key: str):
    """exp_avg or exp_avg_sq in the params tree's layout, on the host; zeros
    where Adam holds none (the Fourier buffers, or before the first step)."""
    opt_state = state.optimizer.state
    whole = ({} if state.shards is None
             else state.shards.whole_moments(state.optimizer, key))

    def leaf(t):
        if id(t) in whole:
            return _to_host(whole[id(t)])
        st = opt_state.get(t) if isinstance(t, torch.nn.Parameter) else None
        return (_to_host(st[key]) if st
                else np.zeros(tuple(t.shape), np.float32))
    return _state_dict(_tree_map(leaf, state.model.params()))


def _optax_state(state: TrainState) -> dict:
    group = state.optimizer.param_groups[0]
    count = np.asarray(state.step, np.int32)
    f32 = lambda v: np.asarray(v, np.float32)
    hyper = {"b1": f32(group["betas"][0]), "b2": f32(group["betas"][1]),
             "eps": f32(group["eps"]), "eps_root": f32(0.0),
             "learning_rate": f32(group["lr"])}
    return {"count": count, "hyperparams": hyper, "hyperparams_states": {},
            "inner_state": {"0": {"count": count,
                                  "mu": _moments(state, "exp_avg"),
                                  "nu": _moments(state, "exp_avg_sq")},
                            "1": {}}}


def _resume_extra(state: TrainState, host_state: dict) -> dict:
    """The resume file's "extra", every tensor copied to the host."""
    extra = {"opt_state": _optax_state(state), "host": host_state}
    if state.generator is None:
        extra["key"] = np.zeros(2, np.uint32)
    else:
        gen = state.generator.get_state().numpy().copy()
        extra[GENERATOR_KEY] = gen
        # a JAX key for the JAX loader, derived without advancing the
        # generator: resuming there draws other noise than here
        extra["key"] = np.asarray(
            [zlib.crc32(gen.tobytes()), state.step & 0xFFFFFFFF], np.uint32)
    return extra


def save_train_state(path: str, state: TrainState, cfg: ModelConfig,
                     host_state: Optional[dict] = None) -> None:
    """Full resume checkpoint: params + optimizer state + the generator +
    host-side controller state (epoch, scheduler, early stopping). A
    tensor-parallel state: every rank calls it (the moments are gathered),
    rank 0 writes."""
    extra = _resume_extra(state, host_state or {})
    if _writes(state):
        save_checkpoint(path, state.model.params(), cfg,
                        step=int(state.step), extra=extra)


def _writes(state: TrainState) -> bool:
    """Whether this rank writes a save of `state`: always, but of a
    tensor-parallel state only rank 0 (every rank gathers)."""
    return state.shards is None or dist.get_rank() == 0


class AsyncCheckpointer:
    """Async save: the snapshot of the state on the host and the msgpack
    encoding happen on the caller's thread (the next train step updates the
    parameters and moments in place, so they must be copied out first); only
    the disk write runs on a background thread, so the epoch loop never
    blocks on IO. wait() joins the write in flight and re-raises its error;
    a new save joins the previous one first. A tensor-parallel state: every
    rank calls save (the snapshot gathers its moments), rank 0 writes; the
    others may give no path."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: Optional[str], state: TrainState, cfg: ModelConfig,
             host_state: Optional[dict] = None) -> None:
        self.wait()
        payload = _payload(state.model.params(), cfg, int(state.step),
                           _resume_extra(state, host_state or {}))
        if path is None or not _writes(state):
            return
        blob = msgpack.packb(payload)

        def write():
            try:
                _write(path, blob)
            except Exception as e:  # surfaced in wait(): disk full, perms
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raise any error it hit, so that a
        failed checkpoint is not silently dropped."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e


def load_train_state(path: str, template_state: TrainState,
                     log: Optional[Callable[[str], None]] = None):
    """Restore a resume file written by either package into
    template_state (a fresh state of the same model and optimizer config):
    the parameters are copied into its model's, Adam's moments, step and
    learning rate into its optimizer. Returns (state, cfg, host_state). A
    file without this package's generator state draws fresh noise from a
    generator seeded with its JAX key, and says so through `log`. A
    tensor-parallel template takes its rank's shards of the file's whole
    parameters and moments."""
    params, cfg, payload = load_checkpoint(path)
    extra = payload["extra"]
    state = template_state
    current = state.model.params()
    pairs = _leaves(current, _state_dict(params), [])
    with torch.no_grad():
        for t, v in pairs:
            t.copy_(torch.from_numpy(np.asarray(v, np.float32)))
    # the optimizer's parameter for each of the model's, and the cut of a
    # whole moment to it (the identity without shards)
    targets = {id(t): (t, lambda v: v) for t, _ in pairs}
    if state.shards is not None:
        targets.update(state.shards.targets())

    opt = extra["opt_state"]
    inner = opt["inner_state"]["0"]
    step = torch.tensor(float(inner["count"]))
    moments = {id(t): (mu, nu) for (t, mu), (_, nu) in zip(
        _leaves(current, inner["mu"], []), _leaves(current, inner["nu"], []))}
    sd = state.optimizer.state_dict()
    index = {id(p): i for i, p in enumerate(
        p for g in state.optimizer.param_groups for p in g["params"])}
    moment = lambda cut, v: cut(torch.from_numpy(np.asarray(v))).clone()
    sd["state"] = {}
    for k, (mu, nu) in moments.items():
        p, cut = targets[k]
        if id(p) in index:
            sd["state"][index[id(p)]] = {"step": step.clone(),
                                         "exp_avg": moment(cut, mu),
                                         "exp_avg_sq": moment(cut, nu)}
    state.optimizer.load_state_dict(sd)
    set_learning_rate(state, float(opt["hyperparams"]["learning_rate"]))
    state.step = int(payload["step"])

    if state.generator is not None:
        if GENERATOR_KEY in extra:
            state.generator.set_state(torch.from_numpy(
                np.asarray(extra[GENERATOR_KEY], np.uint8)))
        else:
            key = np.asarray(extra["key"], np.uint32).reshape(-1)
            seed = int(key[0]) << 32 | int(key[-1])
            state.generator = torch.Generator().manual_seed(seed)
            if log is not None:
                log(f"# {path} holds no torch generator state (written by "
                    f"the JAX package): drawing fresh noise, seeded {seed}")
    return state, cfg, extra.get("host", {})


def save_model_pair(path_prefix: str, params: Any, cfg: ModelConfig,
                    step: int = 0, suffix: str = "") -> None:
    """Write generator{suffix}.sav + inference{suffix}.sav (the reference's
    train->cluster handoff filenames, train_mnist.py:672-681)."""
    save_checkpoint(os.path.join(path_prefix, f"generator{suffix}.sav"),
                    {"generator": params["generator"]}, cfg, step)
    save_checkpoint(os.path.join(path_prefix, f"inference{suffix}.sav"),
                    {"encoder": params["encoder"]}, cfg, step)

