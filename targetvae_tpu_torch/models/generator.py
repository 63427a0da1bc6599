"""SpatialGenerator: coordinate-conditioned MLP decoder
(mirror of targetvae_tpu/models/generator.py).

Reference src/models.py:65-123. Per-pixel output logits from (coords, z):
h = W_c embed(x) + W_z z broadcast over pixels, then `num_layers` - 1 hidden
layers and a final linear to n_out.

Three tiers, chosen where the JAX package chooses (generator.py:23-29,67-105):
  - bf16 on a configuration decoder_kernel_supported covers in the
    direction asked, with a latent: the fused decoder_mlp kernel (K9, K10
    under autograd);
  - any other bf16 generator: the JAX package's XLA recipe in plain
    PyTorch, features computed in float32 and rounded to bf16, bf16 matmul
    operands, float32 accumulation;
  - float32 (compute_dtype=None): plain model code.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..kernels import count_fallback, kernel_tier, needs_grad
from ..kernels.decoder_mlp import decoder_kernel_supported, fused_decoder_mlp
from ..kernels.decoder_pose import _act, bf16_round
from ..ops.fourier import fourier_apply, fourier_init
from ..utils.config import GeneratorConfig
from ..utils.initializers import linear_init


def generator_init(generator: torch.Generator, cfg: GeneratorConfig,
                   device=None) -> dict:
    params: dict = {}
    in_dim = 2
    if cfg.fourier_expansion:
        params["fourier"] = fourier_init(generator, 2, cfg.embedding_dim,
                                         device=device)
        in_dim = cfg.embedding_dim
    params["coord_linear"] = linear_init(generator, in_dim, cfg.hidden_dim,
                                         device=device)
    if cfg.z_dim > 0:
        params["latent_linear"] = linear_init(generator, cfg.z_dim,
                                              cfg.hidden_dim, bias=False,
                                              device=device)
    params["hidden"] = [linear_init(generator, cfg.hidden_dim, cfg.hidden_dim,
                                    device=device)
                        for _ in range(1, cfg.num_layers)]
    params["out"] = linear_init(generator, cfg.hidden_dim, cfg.n_out,
                                device=device)
    return params


def generator_apply(params: dict, cfg: GeneratorConfig, x: torch.Tensor,
                    z: Optional[torch.Tensor],
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (B, N, 2) transformed coordinates; z: (B, z_dim) or None.
    Returns (B, N, n_out) float32."""
    if compute_dtype is not None and not kernel_tier(compute_dtype):
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    bf16 = kernel_tier(compute_dtype)
    if bf16 and z is not None:
        if decoder_kernel_supported(cfg, needs_grad(params, x, z)):
            return fused_decoder_mlp(x, z, params, cfg)
        count_fallback("decoder")
    # the bf16 recipe's matmul: bf16 operands, float32 accumulation
    mm = ((lambda a, w: bf16_round(a) @ bf16_round(w)) if bf16
          else (lambda a, w: a @ w))
    kind = cfg.activation
    if cfg.fourier_expansion:
        x = fourier_apply(params["fourier"], x, cfg.fourier_sigma)
    h = mm(x, params["coord_linear"]["w"]) + params["coord_linear"]["b"]
    if cfg.z_dim > 0 and z is not None:
        h = h + mm(z, params["latent_linear"]["w"])[:, None, :]
    h = _act(h, kind)
    for layer in params["hidden"]:
        pre = mm(h, layer["w"]) + layer["b"]
        h = _act(pre + h if cfg.resid else pre, kind)
    return mm(h, params["out"]["w"]) + params["out"]["b"]


class SpatialGenerator(nn.Module):
    """The decoder's parameters in generator_init's layout, the Fourier w and
    b as buffers (never trained); generator_apply computes with them."""

    def __init__(self, cfg: GeneratorConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.fourier = nn.Module()
        for k, v in params.get("fourier", {}).items():
            self.fourier.register_buffer(k, v)
        pd = lambda sub: nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in sub.items()})
        self.coord_linear = pd(params["coord_linear"])
        self.latent_linear = pd(params.get("latent_linear", {}))
        self.hidden = nn.ModuleList([pd(h) for h in params["hidden"]])
        self.out = pd(params["out"])

    def params(self) -> dict:
        p = {"coord_linear": dict(self.coord_linear.items()),
             "hidden": [dict(h.items()) for h in self.hidden],
             "out": dict(self.out.items())}
        if self.cfg.fourier_expansion:
            p["fourier"] = dict(self.fourier.named_buffers())
        if self.cfg.z_dim > 0:
            p["latent_linear"] = dict(self.latent_linear.items())
        return p
