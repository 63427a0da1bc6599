"""Gumbel-softmax sampling on an explicit torch.Generator
(mirror of targetvae_tpu/ops/gumbel.py).

softmax((logits + g)/tau) with g standard Gumbel noise, as
F.gumbel_softmax(logits, tau=1, hard=False) in the reference encoders.
"""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u clipped to [1e-20, 1-1e-7]."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32).clamp_(1e-20, 1.0 - 1e-7)
    return (-torch.log(-torch.log(u))).to(device)


def gumbel_softmax(logits: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None, tau: float = 1.0,
                   dim: int = -1) -> torch.Tensor:
    """Draws the noise from `generator`, or takes it explicitly (`noise`, of
    the logits' shape) so a test can hand both frameworks the same numbers."""
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return torch.softmax((logits + noise) / tau, dim=dim)
