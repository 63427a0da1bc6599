"""Reconstruction likelihood heads (mirror of targetvae_tpu/losses/likelihoods.py).

Bernoulli (BCE-with-logits, reference train_mnist.py:286-292). Images are
channels-last (B, H, W, C); the generator output is pixel-major
(B, N, n_out), so y_hat[b, n, c] pairs with the pixel value at (n, c). The
Gaussian / CTF / mask heads of the particles datasets are not ported yet
(ROADMAP.md, queue 1, item 19).
"""

from __future__ import annotations

import torch


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE-with-logits, the numerically stable form."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def reconstruction_log_prob(y_hat: torch.Tensor, y: torch.Tensor,
                            kind: str) -> torch.Tensor:
    """Batch-mean reconstruction log-likelihood: -BCE_mean * pixels
    (reference train_mnist.py:291). y_hat (B, N, n_out); y (B, H, W, C)."""
    if kind != "bernoulli":
        raise NotImplementedError(
            f"likelihood {kind!r} is not ported yet (ROADMAP.md, queue 1, item 19)")
    b = y.shape[0]
    logits = y_hat.reshape(b, -1)
    targets = y.reshape(b, -1).to(logits.dtype)
    return -_bce_with_logits(logits, targets).mean() * targets.shape[1]
