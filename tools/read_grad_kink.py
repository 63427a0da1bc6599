#!/usr/bin/env python
"""Read how far the sampled float32 ELBO's gradient moves under a tiny
change of its sampling noise, in the port and in the JAX package, at the
sampled cases of tests/test_torch_port_sp_modes.py.

Both packages take the same weights (the JAX package's init, key 0), the
same 4 images (numpy seed 1) and the same noise: the whole grid's Gumbel
draw and the z and theta normals, drawn in the port's order from a torch
generator seeded --seed, the Gumbel draw scaled by 1 + eps. For each eps
this prints, as the worst leaf's relative L2 (the attention bias, whose
exact gradient is 0, left out): each package's gradient against its own at
eps = 0, and the port's against the JAX package's at the same eps. Next
to a kink of the gradient (a leaky ReLU whose input crosses zero) a change
of 1e-6 moves a package's gradient by far more than 1e-6, and the two
packages, whose sums round differently, may sit on its two sides.

Run on the CPU: python tools/read_grad_kink.py [--mode B --seed 5]
(about 20 s).
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

EPS = (1e-7, -1e-7, 1e-6, -1e-6, 1e-5, -1e-5)
SHIFT = "encoder.conv_a.b"


def config(mode: str):
    """tests/test_torch_port_sp_modes.py's mode-B and mode-C models."""
    from targetvae_tpu_torch.utils.config import (
        EncoderConfig, GeneratorConfig, LikelihoodConfig, ModelConfig)
    gen = GeneratorConfig(z_dim=2, hidden_dim=32, n_out=1, num_layers=2,
                          fourier_expansion=True, embedding_dim=64)
    if mode == "B":
        enc = EncoderConfig(t_inf="attention", r_inf="unimodal",
                            image_dim=14, z_dim=2, kernels_num=16,
                            groupconv=0)
    else:
        enc = EncoderConfig(image_dim=14, z_dim=2, kernels_num=16,
                            kernels_size=8, padding=3, groupconv=4)
    return ModelConfig(gen, enc, LikelihoodConfig())


def _worst(a: dict, b: dict) -> float:
    return max(float(np.linalg.norm(a[n] - b[n])
                     / max(np.linalg.norm(b[n]), 1e-30))
               for n in b if n in a and n != SHIFT)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("B", "C"), default="B")
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import torch
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import targetvae_tpu_torch.losses.elbo as port_elbo
    import targetvae_tpu_torch.models.encoders as port_enc
    from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.utils import config as jcfg
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.ops.gumbel import gumbel_noise
    from targetvae_tpu_torch.utils.jax_params import params_from_jax

    cfg = config(args.mode)
    jm = JaxTargetVAE(jcfg.ModelConfig.from_json(cfg.to_json()))
    jp = jm.init(jax.random.key(0))
    host = jax.tree.map(np.asarray, jp)
    d = cfg.encoder.image_dim
    y = np.random.default_rng(1).uniform(0, 1, (4, d, d, 1)).astype(
        np.float32)

    def noise(eps: float):
        """A function drawing each requested shape in call order: Gumbel
        (scaled by 1 + eps), then normals, from one generator."""
        gen = torch.Generator().manual_seed(args.seed)
        return (lambda shape: gumbel_noise(tuple(shape), gen) * (1 + eps),
                lambda shape: torch.randn(tuple(shape), generator=gen))

    def port(eps: float) -> dict:
        gumbel, normal = noise(eps)
        port_enc.gumbel_softmax = (
            lambda logits, generator=None, noise=None, tau=1.0, dim=-1:
            torch.softmax((logits + gumbel(logits.shape)) / tau, dim=dim))
        port_elbo._normal_noise = lambda g, shape, device: normal(shape)
        model = TargetVAE(cfg, device="cpu")
        model.load_params(params_from_jax(host))
        out = port_elbo.compute_elbo(model.params(), cfg, model.base_grid(),
                                     torch.from_numpy(y),
                                     torch.Generator().manual_seed(0))
        (-out[0]).backward()
        return {n: p.grad.numpy().copy()
                for n, p in model.named_parameters()}

    def jax_grads(eps: float) -> dict:
        gumbel, normal = noise(eps)
        saved = jax.random.gumbel, jax.random.normal
        jax.random.gumbel = lambda key, shape=(), dtype=jnp.float32: \
            jnp.asarray(gumbel(shape).numpy(), dtype)
        jax.random.normal = lambda key, shape=(), dtype=jnp.float32: \
            jnp.asarray(normal(shape).numpy(), dtype)
        try:
            g = jax.grad(lambda p: -jax_compute_elbo(
                p, jm.cfg, jm.base_grid(), jnp.asarray(y),
                jax.random.key(0))[0])(jp)
        finally:
            jax.random.gumbel, jax.random.normal = saved
        out = {}
        for path, v in jax.tree_util.tree_leaves_with_path(g):
            name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                            for p in path)
            out["spatial_" + name if name.startswith("generator")
                else name] = np.asarray(v)
        return out

    p0, j0 = port(0.0), jax_grads(0.0)
    res = {"mode": args.mode, "seed": args.seed,
           "port_vs_jax": _worst(p0, j0), "eps": {}}
    print(f"mode {args.mode}, seed {args.seed}: the port's gradient against "
          f"the JAX package's at eps = 0: {res['port_vs_jax']:.2e}")
    for eps in EPS:
        p, j = port(eps), jax_grads(eps)
        row = {"port_moves": _worst(p, p0), "jax_moves": _worst(j, j0),
               "port_vs_jax": _worst(p, j)}
        res["eps"][eps] = row
        print(f"  eps {eps:+.0e}: the port's moves {row['port_moves']:.2e}, "
              f"the JAX package's {row['jax_moves']:.2e}; port against JAX "
              f"{row['port_vs_jax']:.2e}")
    return res


if __name__ == "__main__":
    main()
