"""Random Fourier feature embedding of 2-D coordinates
(mirror of targetvae_tpu/ops/fourier.py).

z = cos(x @ (W/sigma) + b) with W ~ N(0,1) stored (in_dim, embedding_dim) and
b ~ U(0, 2*pi) (reference src/models.py:33-58). W and b are non-trainable
buffers: sampled once at init, never updated.
"""

from __future__ import annotations

import math

import torch


def fourier_init(generator: torch.Generator, in_dim: int = 2,
                 embedding_dim: int = 1024, device=None) -> dict:
    w = torch.randn((in_dim, embedding_dim), generator=generator,
                    device=generator.device, dtype=torch.float32)
    b = torch.rand((embedding_dim,), generator=generator,
                   device=generator.device, dtype=torch.float32) * 2.0 * math.pi
    return {"w": w.to(device), "b": b.to(device)}


def fourier_apply(params: dict, x: torch.Tensor, sigma: float) -> torch.Tensor:
    """x: (..., in_dim) -> (..., embedding_dim)."""
    w = params["w"].detach()
    b = params["b"].detach()
    return torch.cos(x @ (w / sigma) + b)
