#!/usr/bin/env python
"""Calibrate the bf16-vs-float32 bounds of the particles model at the
EMPIAR shape (chip_smoke.py's phase 15).

Phase 15 holds, on each bf16 encoder tier against the float32 tier and
with no sampling noise, one step's gradients per parameter leaf (relative
L2) and the CTF-filtered decoded mean (relative L2 over the batch's
110 x 110 images), at chip_smoke.empiar_config (110x110, mode C, P8,
K = 128, k = 64, padding 16, z = 2, Fourier decoder F = 1,024, hidden 512,
Gaussian with 109 x 109 CTF kernels and mask radius 45). This script reads
what the JAX package's own bf16 tier does there, on the CPU, on the inputs
phase 15 takes them at: the port's initial weights from the seed
(TargetVAE.init(torch.Generator().manual_seed(seed)), moved into the JAX
pytree; seed 0 is phase 15's), the first `--batch` (100: phase 15's B) of
chip_smoke.particle_images(200, 3 + seed) and of chip_smoke.empiar_ctf's
kernels (physical units). The batch is taken in chunks of `--chunk`
images, whose gradients of the batch-mean ELBO are summed with weight
chunk / batch: the batch's gradient up to float32 summation order, at a
chunk's memory. The JAX bf16 tier is its TPU tier (--tier kernels: the
mix_heads and pose-decoder Pallas kernels interpreted, the 1-D-conv lift
in bf16) or its XLA recipe (--tier recipe), as
tools/calibrate_mode_b_grad_tol.py runs them; its CTF is the exact
convolution on both tiers. Beside each reading it prints the port's own on
the same inputs (its bf16 tier on the CPU: the kernels' plain versions,
which round where the kernels do), so that the two packages are held to
one another.

Run on the CPU: python tools/calibrate_particles_grad_tol.py [--seeds 1]
[--batch 100] [--chunk 5] [--tier kernels] [--no-port]. Prints, per leaf
(the port's names) and for the filtered mean ("mu_ctf"), the largest JAX
and port readings over the seeds, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

MU = "mu_ctf"   # the CTF-filtered decoded mean's reading


def port_name(jax_key: str) -> str:
    """'encoder/conv1/w' -> 'encoder.conv1.w'; 'generator/...' ->
    'spatial_generator....' (the port's named_parameters)."""
    parts = jax_key.split("/")
    if parts[0] == "generator":
        parts[0] = "spatial_generator"
    return ".".join(parts)


def readings(g16: dict, g32: dict, mu16, mu32, rel) -> dict:
    """Relative L2 per leaf and of the filtered mean. Not the attention
    head's bias: the softmax over the cells is invariant to a shift of
    every logit, so its exact gradient is zero and both tiers hold rounding
    noise (chip_smoke.check_tier_grads holds it to a floor apart)."""
    out = {n: rel(g16[n], g32[n]) for n in g32 if n != "encoder.conv_a.b"}
    out[MU] = rel(mu16, mu32)
    return out


def distances(seed: int, batch: int, chunk: int, tier: str,
              port: bool) -> tuple:
    """({leaf or MU: JAX bf16-vs-f32 rel L2}, the port's or None)."""
    import torch
    import chip_smoke as cs
    import targetvae_tpu.losses.elbo as jax_el
    import targetvae_tpu_torch.losses.elbo as port_el
    from calibrate_mode_b_grad_tol import rel, tpu_tier_no_noise
    from targetvae_tpu.losses.likelihoods import ctf_apply as jax_ctf
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.utils import config as jcfg
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.losses.likelihoods import ctf_apply as port_ctf
    from targetvae_tpu_torch.utils.config import ModelConfig
    from targetvae_tpu_torch.utils.jax_params import params_to_jax

    cfg = cs.empiar_config()
    jc = jcfg.ModelConfig.from_json(cfg.to_json())
    jm = JaxTargetVAE(jc)
    model = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    params = jax.tree.map(jnp.asarray, params_to_jax(
        model.init(torch.Generator().manual_seed(seed))))
    y = cs.particle_images(2 * cs.B, 3 + seed)[:batch]
    ctf = cs.empiar_ctf(torch, 2 * cs.B, "cpu").numpy()[:batch]
    spans = [slice(i, min(i + chunk, batch)) for i in range(0, batch, chunk)]

    def jax_chunk(dt, yc, cc):
        seen = {}

        def loss(p):
            with cs.filtered_mean(jax_el, jax_ctf, seen):
                out = -jax_el.compute_elbo(
                    p, jc, jm.base_grid(), yc, jax.random.key(1), ctf=cc,
                    compute_dtype=dt, allow_kernels=tier == "kernels")[0]
            return out, seen["mu"]
        return jax.jit(jax.grad(loss, has_aux=True))(params)

    def jax_tier(dt):
        total, mus = None, []
        for s in spans:
            g, mu = jax_chunk(dt, jnp.asarray(y[s]), jnp.asarray(ctf[s]))
            w = (s.stop - s.start) / batch
            g = jax.tree.map(lambda a: np.asarray(a, np.float64) * w, g)
            total = g if total is None else jax.tree.map(np.add, total, g)
            mus.append(np.asarray(mu))
        flat = {}
        for path, a in jax.tree_util.tree_leaves_with_path(total):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            if "fourier" not in key:
                flat[port_name(key)] = a
        return flat, np.concatenate(mus)

    with tpu_tier_no_noise(tier):
        (g16, m16), (g32, m32) = jax_tier(jnp.bfloat16), jax_tier(None)
    ours = readings(g16, g32, m16, m32, rel)
    if not port:
        return ours, None

    def port_tier(dt):
        model.zero_grad(set_to_none=True)
        mus = []
        for s in spans:
            seen = {}
            with cs.filtered_mean(port_el, port_ctf, seen):
                loss = -port_el.compute_elbo(
                    model.params(), cfg, model.base_grid(),
                    torch.from_numpy(y[s]), None, dt,
                    ctf=torch.from_numpy(ctf[s]))[0]
            (loss * (s.stop - s.start) / batch).backward()
            mus.append(seen["mu"].detach().numpy())
        return ({n: p.grad.detach().numpy().astype(np.float64)
                 for n, p in model.named_parameters()}, np.concatenate(mus))
    (p16, pm16), (p32, pm32) = port_tier(torch.bfloat16), port_tier(None)
    return ours, readings(p16, p32, pm16, pm32, rel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=5)
    ap.add_argument("--tier", choices=("kernels", "recipe"),
                    default="kernels")
    ap.add_argument("--no-port", action="store_true",
                    help="read the JAX package only")
    args = ap.parse_args()
    jax_runs, port_runs = [], []
    for s in range(args.seeds):
        j, p = distances(s, args.batch, args.chunk, args.tier,
                         not args.no_port)
        jax_runs.append(j)
        port_runs.append(p or {})
        print(f"seed {s}: " + json.dumps(
            {n: [round(j[n], 4)] + ([round(p[n], 4)] if p else [])
             for n in sorted(j)}), flush=True)
    worst = lambda runs: {n: max(r[n] for r in runs) for n in jax_runs[0]
                          if all(n in r for r in runs)}
    worst_jax, worst_port = worst(jax_runs), worst(port_runs)
    for n in sorted(worst_jax):
        port = (f", port {worst_port[n]:.4f}" if n in worst_port else "")
        print(f"  {n}: JAX {worst_jax[n]:.4f}{port}", flush=True)
    print(json.dumps({"tier": args.tier, "batch": args.batch,
                      "chunk": args.chunk, "seeds": args.seeds,
                      "jax": worst_jax, "port": worst_port}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
