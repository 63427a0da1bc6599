#!/usr/bin/env python
"""Calibrate the bf16-vs-float32 gradient bound of mode B's theta heads.

chip_smoke.py's phase 13 holds one deterministic step's gradients on the
bf16 tier against the float32 tier's, per parameter leaf, at the full
widths of mnist-b and mnist-b-p8 (50x50 images, K = 128, z = 2, a Fourier
decoder of F = 1,024 and hidden 512, theta prior pi). Every leaf but the
theta heads (conv_r) stays far inside 0.05 there. This script reads what
the JAX package's own bf16 tier does on that leaf: for each config and
each of `--seeds` seeds (weights and images), the relative L2 distance
between the JAX package's bf16 and float32 gradients of -ELBO (no noise)
on the CPU, per leaf, over `--batch` images shaped as chip_smoke's
synthetic_images. Two bf16 tiers (--tier):

  kernels: the JAX package's TPU tier, its Pallas kernels in interpret
    mode: the encoder targetvae_tpu/models/encoders.py::_mode_b_fast with
    K1 at R = 1 (kernels/mix_heads.py), the decoder K7/K8
    (kernels/decoder_pose.py), which the port's bf16 tier runs as K1/K2 at
    R = 1 and K7/K8 on the card; the posterior on its float32 plain branch
    (K3/K4 compute in float32 on both tiers);
  recipe: _mode_b_fast's XLA recipe (allow_kernels=False: the lift in
    bf16, h1, the folded mixing, h2 and the head weights rounded to bf16)
    and the decoder's bf16 XLA path (its CPU route), the posterior plain.

It prints the largest over the seeds for every leaf and for the theta heads.
With --dump DIR it also writes each reading's inputs and distances
(DIR/<config>_s<seed>_b<batch>.pkl: the weights as numpy arrays in the JAX
package's layout, the images, the per-leaf distances), which
tools/read_mode_b_grad_gap.py --from DIR reads on the card through the
port, so that the two packages are held to one another on the same inputs.

Run on the CPU: python tools/calibrate_mode_b_grad_tol.py [--seeds 4]
[--batch 10] [--tier kernels] [--configs mnist-b mnist-b-p8] [--dump DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import pickle
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")


def config(name: str):
    """mnist-b / mnist-b-p8 as chip_smoke.py's mode_config builds them."""
    from targetvae_tpu.utils import config as jcfg
    d = 50
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(z_dim=2, hidden_dim=512, n_out=1,
                                       num_layers=2, fourier_expansion=True,
                                       fourier_sigma=2.0 / (d - 1)),
        encoder=jcfg.EncoderConfig(t_inf="attention", r_inf="unimodal",
                                   image_dim=d, in_channels=1, z_dim=2,
                                   kernels_num=128,
                                   groupconv=8 if name.endswith("p8") else 0,
                                   theta_prior=np.pi),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


def synthetic_images(n: int, d: int, seed: int) -> np.ndarray:
    """chip_smoke.py's stand-ins: three Gaussian strokes per image at random
    positions, in [0, 1], (n, d, d, 1) float32."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-1, 1, d, dtype=np.float32)
    yy, xx = np.meshgrid(g, g, indexing="ij")
    img = np.zeros((n, d, d), np.float32)
    for _ in range(3):
        cx, cy = rng.uniform(-0.5, 0.5, (2, n, 1, 1)).astype(np.float32)
        sx, sy = rng.uniform(0.05, 0.25, (2, n, 1, 1)).astype(np.float32)
        img += np.exp(-((xx - cx) / sx) ** 2 - ((yy - cy) / sy) ** 2)
    return np.clip(img, 0, 1)[..., None]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@contextlib.contextmanager
def tpu_tier_no_noise(tier: str):
    """The JAX package's bf16 routes of `tier` on the CPU (the module
    docstring) and no sampling noise: zero reparameterisation normals, the
    plain softmax for the Gumbel sample. Only around the loss: the
    initialisers draw normals too. The encoders module reads its backend
    as "tpu", so that mode B's bf16 encoder is _mode_b_fast; under
    "kernels" the mix_heads and pose-decoder kernels run interpreted, and
    the ELBO's pose-decoder gate ignores the backend."""
    import targetvae_tpu.kernels.decoder_pose as DP
    import targetvae_tpu.kernels.mix_heads as MH
    import targetvae_tpu.losses.elbo as EL
    import targetvae_tpu.models.encoders as EN

    class TpuJax:
        def __getattr__(self, attr):
            return getattr(jax, attr)

        @staticmethod
        def default_backend():
            return "tpu"

    saved = (EN.jax, jax.random.normal, EN.gumbel_softmax,
             MH.fused_lift_act_mix_heads, DP.fused_pose_decoder,
             EL._use_pose_decoder)
    EN.jax = TpuJax()
    jax.random.normal = (lambda key, shape=(), dtype=jnp.float32:
                         jnp.zeros(shape, dtype))
    EN.gumbel_softmax = (lambda key, logits, tau=1.0, axis=-1:
                         jax.nn.softmax(logits, axis=axis))
    if tier == "kernels":
        MH.fused_lift_act_mix_heads = functools.partial(
            saved[3], interpret=True)
        DP.fused_pose_decoder = functools.partial(saved[4], interpret=True)
        EL._use_pose_decoder = lambda gcfg, dt: (
            dt == jnp.bfloat16 and DP.pose_decoder_supported(gcfg))
    try:
        yield
    finally:
        (EN.jax, jax.random.normal, EN.gumbel_softmax,
         MH.fused_lift_act_mix_heads, DP.fused_pose_decoder,
         EL._use_pose_decoder) = saved


def distances(name: str, seed: int, batch: int, tier: str,
              dump: str = "") -> dict:
    """Per leaf "group/name/param", the bf16-vs-float32 relative L2 of the
    JAX package's gradients of -ELBO, no noise; with `dump`, the inputs and
    the distances written there."""
    from targetvae_tpu.losses.elbo import compute_elbo
    from targetvae_tpu.models import TargetVAE
    cfg = config(name)
    model = TargetVAE(cfg)
    params = model.init(jax.random.key(seed))
    y = jnp.asarray(synthetic_images(batch, 50, 3 + seed))

    def grads(dt):
        loss = lambda p: -compute_elbo(p, cfg, model.base_grid(), y,
                                       jax.random.key(1), compute_dtype=dt,
                                       allow_kernels=tier == "kernels")[0]
        return jax.jit(jax.grad(loss))(params)

    with tpu_tier_no_noise(tier):
        g16, g32 = grads(jnp.bfloat16), grads(None)
    out = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g16),
                            jax.tree.leaves(g32)):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        if "fourier" not in key:
            out[key] = rel(a, b)
    if dump:
        os.makedirs(dump, exist_ok=True)
        with open(os.path.join(dump, f"{name}_s{seed}_b{batch}.pkl"),
                  "wb") as f:
            pickle.dump({"config": name, "seed": seed, "tier": tier,
                         "params": jax.tree.map(np.asarray, params),
                         "images": np.asarray(y), "jax_gaps": out}, f)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--tier", choices=("kernels", "recipe"),
                    default="kernels")
    ap.add_argument("--dump", default="")
    ap.add_argument("--configs", nargs="+",
                    default=["mnist-b", "mnist-b-p8"])
    args = ap.parse_args()
    report = {}
    for name in args.configs:
        per = []
        for s in range(args.seeds):
            per.append(distances(name, s, args.batch, args.tier,
                                 args.dump))
            theta_s = {n: round(v, 4) for n, v in per[-1].items()
                       if "conv_r" in n}
            print(f"{name} seed {s}: theta heads {theta_s}", flush=True)
        worst = {n: max(p[n] for p in per) for n in per[0]}
        theta = max(v for n, v in worst.items() if "conv_r" in n)
        rest = max(v for n, v in worst.items()
                   if "conv_r" not in n and n != "encoder/conv_a/b")
        report[name] = {"leaves": worst, "theta_heads": theta,
                        "others": rest, "per_seed_theta": [
                            max(v for n, v in p.items() if "conv_r" in n)
                            for p in per]}
        print(f"{name}, {args.tier} tier, {args.batch} images: largest "
              f"over {args.seeds} "
              f"seeds: theta heads {theta:.4f}, other leaves {rest:.4f}",
              flush=True)
        for n, v in sorted(worst.items()):
            print(f"  {n}: {v:.4f}", flush=True)
    print(json.dumps({"tier": args.tier, "batch": args.batch,
                      "seeds": args.seeds, "configs": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
