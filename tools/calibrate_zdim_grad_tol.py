#!/usr/bin/env python
"""Calibrate the bf16-vs-float32 gradient bound of the wide-latent routes.

tests/test_torch_port_train.py::test_bf16_wide_latent_routes_track_jax
holds the port's bf16 gradients at z_dim 8 and 10 (the encoder past its
kernels' 16 heads, the posterior past K3/K4's z <= 8 at z_dim 10) against
its float32 gradients per parameter leaf. The 0.15 / 0.2 bounds of the
narrower configs do not transfer: at z_dim 8 the theta heads' bias moved
past 0.2 at the tests' size. This script measures what the JAX package's
own bf16 tier does at that size: for each z_dim and each of `--seeds`
seeds (weights and images), the relative L2 distance between the JAX
package's bf16 and float32 gradients of -ELBO (no noise) on the CPU, per
leaf, and prints the largest over the seeds for every leaf and the
largest of each group the test bounds (the theta heads, conv_r; every
other leaf but the attention bias, whose exact gradient is zero). Two
bf16 encoders: "cpu", the JAX package's bf16 path on the CPU (the lift
conv in bf16, the rest in float32), and "recipe", its TPU tier's XLA bf16
recipe (targetvae_tpu/models/encoders.py::_mode_c_xla_matmul without its
kernel: h1, W2, h2 and the head weights rounded to bf16), which the
port's bf16 tier computes past its kernels' widths.

Run on the CPU: python tools/calibrate_zdim_grad_tol.py [--seeds 8]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")


def config(zd: int):
    """The tests' small mode-C model (tests/test_torch_port_train.py) at
    z_dim zd."""
    from targetvae_tpu.utils import config as jcfg
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(z_dim=zd, hidden_dim=32, n_out=1,
                                       num_layers=2, fourier_expansion=True,
                                       fourier_sigma=2.0 / 13,
                                       embedding_dim=64),
        encoder=jcfg.EncoderConfig(image_dim=14, z_dim=zd, kernels_num=16,
                                   kernels_size=8, padding=3, groupconv=4),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def use_recipe(on: bool) -> None:
    """Route the JAX package's bf16 mode-C encoder to its TPU tier's XLA
    recipe on the CPU (on), or back to its CPU path."""
    import targetvae_tpu.models.encoders as EN
    if not hasattr(EN, "_calibrate_saved"):
        EN._calibrate_saved = (EN._use_encoder_kernel, EN._mode_c_kernel)
    if on:
        EN._use_encoder_kernel = lambda cfg, dt: dt == jnp.bfloat16
        EN._mode_c_kernel = lambda p, cfg, y: EN._mode_c_xla_matmul(
            p, cfg, y, allow_kernels=False)
    else:
        EN._use_encoder_kernel, EN._mode_c_kernel = EN._calibrate_saved


@contextlib.contextmanager
def no_noise():
    """No sampling noise in the ELBO, as the tests' zero_noise fixture: zero
    reparameterisation normals, the plain softmax for the Gumbel sample.
    Only around the loss: the weights' initialisers draw normals too."""
    import targetvae_tpu.models.encoders as EN
    saved = jax.random.normal, EN.gumbel_softmax
    jax.random.normal = (lambda key, shape=(), dtype=jnp.float32:
                         jnp.zeros(shape, dtype))
    EN.gumbel_softmax = (lambda key, logits, tau=1.0, axis=-1:
                         jax.nn.softmax(logits, axis=axis))
    try:
        yield
    finally:
        jax.random.normal, EN.gumbel_softmax = saved


def distances(zd: int, seed: int) -> dict:
    """Per leaf "group/name/param", the bf16-vs-float32 relative L2 of the
    JAX package's gradients of -ELBO, no noise, 3 images."""
    from targetvae_tpu.losses.elbo import compute_elbo
    from targetvae_tpu.models import TargetVAE
    cfg = config(zd)
    model = TargetVAE(cfg)
    params = model.init(jax.random.key(seed))
    y = jnp.asarray(np.random.default_rng(seed).uniform(
        0, 1, (3, 14, 14, 1)).astype(np.float32))

    def grads(dt):
        loss = lambda p: -compute_elbo(p, cfg, model.base_grid(), y,
                                       jax.random.key(1), compute_dtype=dt)[0]
        return jax.grad(loss)(params)

    with no_noise():
        g16, g32 = grads(jnp.bfloat16), grads(None)
    out = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g16),
                            jax.tree.leaves(g32)):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        if "fourier" not in name:
            out[name] = rel(a, b)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    report = {}
    for tier in ("cpu", "recipe"):
        use_recipe(tier == "recipe")
        for zd in (8, 10):
            per = [distances(zd, s) for s in range(args.seeds)]
            worst = {n: max(p[n] for p in per) for n in per[0]}
            theta = max(v for n, v in worst.items() if "conv_r" in n)
            rest = max(v for n, v in worst.items()
                       if "conv_r" not in n and n != "encoder/conv_a/b")
            report[f"{tier} z_dim {zd}"] = {"leaves": worst,
                                           "theta_heads": theta,
                                           "others": rest}
            print(f"{tier} encoder, z_dim {zd}: largest over {args.seeds} "
                  f"seeds: theta heads {theta:.4f}, other leaves "
                  f"{rest:.4f}", flush=True)
            for n, v in sorted(worst.items()):
                print(f"  {n}: {v:.4f}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
