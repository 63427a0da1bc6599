#!/usr/bin/env python
"""Read how far a dp = 2 ragged epoch drifts from its one-device run, in
the JAX package and in the port, from the same inputs.

Both packages train the same bf16 model from the same weights (the JAX
package's init) on the same rows in the same order (the JAX epoch's
shuffle): an epoch of 10 full batches and a ragged tail (11 Adam steps) at
learning rate 2e-4, without sampling noise, once on one device and once
with dp = 2 (the JAX package on a 2-device CPU mesh, its tail padded with
zero-weight rows; the port on 2 gloo ranks, likewise padded). The JAX
package runs its dp step two ways: "jax_gspmd", the whole batch under
GSPMD, its path on the CPU, and "jax_shard_map", the per-shard loss under
shard_map (_loss_fn_dp), its path on the TPU, which the port's ranks
mirror: each shard computes its gradients, bf16 weight-gradient products
rounded to bf16 over its own rows, and the shards' gradients are summed.
Each step's gradient then differs between the two runs only by rounding;
Adam moves a weight by about the learning rate whatever its gradient's
size, so a near-zero gradient whose sign the rounding flips moves the
weight the other way, and the runs part. For each this prints the drift of
the epoch's means (max relative difference of elbo, gen_loss, kl) and of
conv1's update (relative L2 of the dp run's weight change against the
one-device run's).

Where the drift starts: at each step's weights of the JAX package's
one-device run, each package's dp = 2 gradient of that step's batch
against its own one-device gradient, leaf by leaf (relative L2), on the
same weights and rows in both packages. The per-step table prints the
median and the largest of the leaves' differences and conv1's for each
path; --out writes every leaf's.

XLA on the CPU computes bf16 operations with excess precision unless told
not to; the script turns that off (--xla_allow_excess_precision=false), so
that the JAX package rounds where it declares bf16, as its TPU does.

Run on the CPU: python tools/read_dp_drift.py [--rows 105 --batch 10
--seeds 0 1 2 --out drift.json] (about two minutes a seed).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

LR = 2e-4


def config_json() -> str:
    """A small flagship-family model: mode C, P4, 16 kernels, a Fourier
    decoder of hidden 32 (tests/test_torch_port_dp.py's)."""
    from targetvae_tpu_torch.utils.config import (
        EncoderConfig, GeneratorConfig, LikelihoodConfig, ModelConfig)
    d = 14
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=32, n_out=1,
                                  num_layers=2, fourier_expansion=True,
                                  fourier_sigma=2.0 / (d - 1),
                                  embedding_dim=64),
        encoder=EncoderConfig(image_dim=d, z_dim=2, kernels_num=16,
                              kernels_size=8, padding=3, groupconv=4),
        likelihood=LikelihoodConfig(kind="bernoulli")).to_json()


def drift(means, means1, w, w1, w0) -> dict:
    means, means1 = np.asarray(means, np.float64), np.asarray(means1,
                                                              np.float64)
    upd, upd1 = (np.asarray(w, np.float64) - w0,
                 np.asarray(w1, np.float64) - w0)
    return {"means_rel": float(np.max(np.abs(means - means1)
                                      / np.abs(means1))),
            "conv1_update_rel": float(np.linalg.norm(upd - upd1)
                                      / np.linalg.norm(upd1))}


def port_epoch(rank: int, world: int, cfg_json: str, params, data,
               batch: int) -> dict:
    """The port's deterministic epoch over `data` in order, on one process
    (world 1) or over dp = world ranks: the means and conv1's weight."""
    from targetvae_tpu_torch import ModelConfig
    from targetvae_tpu_torch.train import Trainer, create_train_state
    from targetvae_tpu_torch.utils.config import TrainConfig
    tr = Trainer(ModelConfig.from_json(cfg_json), TrainConfig(
        learning_rate=LR, compute_dtype="bfloat16", minibatch_size=batch,
        dp=world), device="cpu")
    tr.model.load_params(_clone(params))     # training updates in place
    state = create_train_state(tr.model, LR, None)
    state, means = tr.train_epoch(state, data)
    return {"means": means, "steps": state.step,
            "conv1": tr.model.params()["encoder"]["conv1"]["w"]
            .detach().numpy().copy()}


def port_grads(rank: int, world: int, cfg_json: str, steps, batch: int
               ) -> list:
    """The port's bf16 gradients of each (params, rows) in `steps`, on one
    process (world 1) or dp = world ranks, the rows split (and a ragged
    tail padded with a zero-weight row) as train_epoch splits them: a
    {name: gradient} for each step."""
    import torch
    from targetvae_tpu_torch import ModelConfig
    from targetvae_tpu_torch.train import Trainer, create_train_state
    from targetvae_tpu_torch.utils.config import TrainConfig
    tr = Trainer(ModelConfig.from_json(cfg_json), TrainConfig(
        learning_rate=0.0, compute_dtype="bfloat16", minibatch_size=batch,
        dp=world), device="cpu")
    out = []
    for params, y in steps:
        tr.model.load_params(_clone(params))
        state = create_train_state(tr.model, 0.0, None)
        y, w = torch.from_numpy(y), None
        if world > 1:
            if len(y) < batch:
                idx, w = tr._pad_tail(torch.arange(len(y)), len(y))
                y = y[idx]
            y, w = tr._mine(y, w)
        tr._step(state, y, w)
        out.append({n: p.grad.numpy().copy()
                    for n, p in tr.model.named_parameters()})
    return out


def adam_update(g, moments, t: int) -> np.ndarray:
    """Adam's update (optax.adam, lr LR) of gradient g after t - 1 steps
    that left the moments (mu, nu)."""
    g = np.asarray(g, np.float64)
    mu, nu = moments
    m = 0.9 * mu + 0.1 * g
    v = 0.999 * nu + 0.001 * g * g
    return -LR * (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.999 ** t))
                                         + 1e-8)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@contextlib.contextmanager
def no_noise(jax, jnp):
    """The JAX ELBO without sampling noise: zero reparameterisation
    normals, the plain softmax for the Gumbel sample."""
    import targetvae_tpu.models.encoders as EN
    normal, gumbel = jax.random.normal, EN.gumbel_softmax
    jax.random.normal = lambda key, shape=(), dtype=jnp.float32: \
        jnp.zeros(shape, dtype)
    EN.gumbel_softmax = lambda key, logits, tau=1.0, axis=-1: \
        jax.nn.softmax(logits, axis=axis)
    try:
        yield
    finally:
        jax.random.normal, EN.gumbel_softmax = normal, gumbel


def _port_name(path) -> str:
    """A JAX pytree path as the port's parameter name."""
    name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)
    return "spatial_" + name if name.startswith("generator") else name


def read_seed(seed: int, rows: int, batch: int, jax, jnp) -> dict:
    """One seed's drift of the means and of conv1's update, and its
    per-step gradient table, in both packages."""
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.parallel import make_mesh
    from targetvae_tpu.parallel.pjit import shard_state
    from targetvae_tpu.train import Trainer as JaxTrainer
    from targetvae_tpu.utils import config as jcfg
    from targetvae_tpu_torch.parallel.distributed import run_local
    from targetvae_tpu_torch.utils.jax_params import params_from_jax

    cfg_json = config_json()
    d = 14
    data = np.random.default_rng(seed).uniform(
        0, 1, (rows, d, d, 1)).astype(np.float32)
    jm = JaxTargetVAE(jcfg.ModelConfig.from_json(cfg_json))
    tcfg = dict(learning_rate=LR, compute_dtype="bfloat16",
                minibatch_size=batch)
    one = JaxTrainer(jm, jcfg.TrainConfig(**tcfg))
    mesh = make_mesh(jax.devices()[:2], data=2, model=1)
    two = {}
    for path in ("gspmd", "shard_map"):
        two[path] = JaxTrainer(jm, jcfg.TrainConfig(dp=2, **tcfg))
        two[path].attach_mesh(mesh)
    # the TPU's per-shard path: the loss under shard_map, the kernels'
    # XLA tiers inside it (the kernels themselves run on the TPU only)
    two["shard_map"]._kernels_would_engage = lambda: True
    state0 = one.init_state(seed)
    w0 = np.asarray(state0.params["encoder"]["conv1"]["w"], np.float64)
    params = params_from_jax(jax.tree.map(np.asarray, state0.params))
    # the JAX epoch's order (train_epoch's split of the state key), which
    # the port takes as its data's order
    perm = np.asarray(jax.random.permutation(
        jax.random.split(state0.key)[1], rows))
    out = {"seed": seed, "rows": rows, "batch": batch, "lr": LR,
           "steps": -(-rows // batch)}
    ordered = np.ascontiguousarray(data[perm])
    with no_noise(jax, jnp):
        s1, m1 = one.train_epoch(one.init_state(seed), jnp.asarray(data))
        for path, tr in two.items():
            s2, m2 = tr.train_epoch(shard_state(mesh, tr.init_state(
                seed)), jnp.asarray(data))
            out["jax_" + path] = drift(
                m2, m1, s2.params["encoder"]["conv1"]["w"],
                s1.params["encoder"]["conv1"]["w"], w0)

        # each step's weights of the JAX one-device run, and its rows
        batches = [ordered[i:i + batch] for i in range(0, rows, batch)]
        step = jax.jit(one._step_impl)
        state, weights, moments = state0, [], []
        for y in batches:
            weights.append(state.params)
            inner = state.opt_state.inner_state[0]
            moments.append(tuple(np.asarray(m["encoder"]["conv1"]["w"],
                                            np.float64)
                                 for m in (inner.mu, inner.nu)))
            state, _ = step(state, jnp.asarray(y))
        key = jax.random.key(0)

        def jax_grads(tr, p, y):
            w = None
            if tr is not one and len(y) < batch:
                idx, w = tr._pad_tail(jnp.arange(len(y)), len(y))
                y = y[np.asarray(idx)]
            g = jax.jit(jax.grad(lambda q: tr._loss_fn(
                q, jnp.asarray(y), key, None, w)[0]))(p)
            return {_port_name(k): np.asarray(v)
                    for k, v in jax.tree_util.tree_leaves_with_path(g)}
        grads = {"jax_one": [jax_grads(one, p, y)
                             for p, y in zip(weights, batches)]}
        for path, tr in two.items():
            grads["jax_" + path] = [jax_grads(tr, p, y)
                                    for p, y in zip(weights, batches)]
    steps = [(params_from_jax(jax.tree.map(np.asarray, p)), y)
             for p, y in zip(weights, batches)]
    grads["port_one"] = port_grads(0, 1, cfg_json, steps, batch)
    grads["port"] = run_local(port_grads, 2, backend="gloo", timeout=600,
                              args=(cfg_json, steps, batch))[0]

    p1 = port_epoch(0, 1, cfg_json, params, ordered, batch)
    p2 = run_local(port_epoch, 2, backend="gloo", timeout=600,
                   args=(cfg_json, params, ordered, batch))[0]
    assert p1["steps"] == p2["steps"] == out["steps"]
    out["port"] = drift(p2["means"], p1["means"], p2["conv1"], p1["conv1"],
                        w0)

    # leaf by leaf, each dp path's gradient against its package's one
    # device gradient (the Fourier buffers are never trained)
    out["grads"] = {}
    for path, ref in (("jax_gspmd", "jax_one"), ("jax_shard_map", "jax_one"),
                      ("port", "port_one")):
        out["grads"][path] = [
            {n: _rel(g[n], r[n]) for n in r if n in g and "fourier" not in n
             and float(np.linalg.norm(r[n])) > 0}
            for g, r in zip(grads[path], grads[ref])]
    # conv1's Adam update from each dp gradient against the update from
    # its package's one-device gradient, both from the JAX one-device run's
    # moments at that step: what the step adds to the drift of conv1
    out["conv1_adam_update"] = {
        path: [_rel(adam_update(g["encoder.conv1.w"], mo, k + 1),
                    adam_update(r["encoder.conv1.w"], mo, k + 1))
               for k, (g, r, mo) in enumerate(zip(grads[path], grads[ref],
                                                  moments))]
        for path, ref in (("jax_gspmd", "jax_one"),
                          ("jax_shard_map", "jax_one"),
                          ("port", "port_one"))}
    # conv1's entries whose gradient's sign (-, 0 or +) the dp run turns:
    # Adam's first steps move a weight by about LR in its gradient's sign
    # whatever the gradient's size
    out["conv1_sign_turns"] = {
        path: [int((np.sign(g["encoder.conv1.w"])
                    != np.sign(r["encoder.conv1.w"])).sum())
               for g, r in zip(grads[path], grads[ref])]
        for path, ref in (("jax_gspmd", "jax_one"),
                          ("jax_shard_map", "jax_one"),
                          ("port", "port_one"))}
    # the two packages' one-device gradients on the same weights and rows
    out["grads"]["port_one_vs_jax_one"] = [
        {n: _rel(g[n], r[n]) for n in r if n in g and "fourier" not in n
         and float(np.linalg.norm(r[n])) > 0}
        for g, r in zip(grads["port_one"], grads["jax_one"])]
    return out


def print_tables(outs: list) -> None:
    """The per-seed drift table and, for each seed, the per-step table of
    the gradients' differences (median and largest leaf, and conv1)."""
    paths = ("jax_gspmd", "jax_shard_map", "port")
    print("seed | " + " | ".join(f"{p} means, conv1 update" for p in paths))
    for o in outs:
        print(f"{o['seed']} | " + " | ".join(
            f"{o[p]['means_rel']:.2e}, {o[p]['conv1_update_rel']:.2e}"
            for p in paths))
    cols = paths + ("port_one_vs_jax_one",)
    for o in outs:
        print(f"seed {o['seed']}: dp = 2 gradient against one device, "
              f"relative L2 over the leaves (median / largest / conv1.w); "
              f"then conv1's Adam update from it against one device's, "
              f"and conv1's entries whose gradient's sign it turns")
        print("step | " + " | ".join(cols) + " | "
              + " | ".join(f"{p} conv1 update" for p in paths) + " | "
              + " | ".join(f"{p} turns" for p in paths))
        for k in range(o["steps"]):
            cells = []
            for c in cols:
                v = o["grads"][c][k]
                cells.append(f"{np.median(list(v.values())):.1e} / "
                             f"{max(v.values()):.1e} / "
                             f"{v['encoder.conv1.w']:.1e}")
            cells += [f"{o['conv1_adam_update'][p][k]:.1e}" for p in paths]
            cells += [str(o["conv1_sign_turns"][p][k]) for p in paths]
            print(f"{k + 1} | " + " | ".join(cells))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=105)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", help="write every seed's leaf-by-leaf tables "
                    "here (JSON)")
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=2"
    if "xla_allow_excess_precision" not in flags:
        flags += " --xla_allow_excess_precision=false"
    os.environ["XLA_FLAGS"] = flags
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    outs = [read_seed(seed, args.rows, args.batch, jax, jnp)
            for seed in args.seeds]
    print_tables(outs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(outs, f)
    return outs


if __name__ == "__main__":
    main()
