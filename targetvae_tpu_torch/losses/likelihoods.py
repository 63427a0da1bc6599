"""Reconstruction likelihood heads (mirror of targetvae_tpu/losses/likelihoods.py).

Bernoulli (BCE-with-logits, reference train_mnist.py:286-292). Images are
channels-last (B, H, W, C); the generator output is pixel-major
(B, N, n_out), so y_hat[b, n, c] pairs with the pixel value at (n, c). The
Gaussian / CTF / mask heads of the particles datasets are not ported yet
(ROADMAP.md, queue 1, item 19).
"""

from __future__ import annotations

from typing import Optional

import torch


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE-with-logits, the numerically stable form."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def reconstruction_log_prob(y_hat: torch.Tensor, y: torch.Tensor,
                            kind: str,
                            row_weights: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Batch-mean reconstruction log-likelihood: -BCE_mean * pixels
    (reference train_mnist.py:291). y_hat (B, N, n_out); y (B, H, W, C).

    row_weights: optional (B,) per-image weights. When given, the batch mean
    becomes the weighted SUM of per-image log-likelihoods; the caller owns
    the normalisation (1/n_real over the real rows of a zero-weight-padded
    tail batch, train/loop.py)."""
    if kind != "bernoulli":
        raise NotImplementedError(
            f"likelihood {kind!r} is not ported yet (ROADMAP.md, queue 1, item 19)")
    b = y.shape[0]
    logits = y_hat.reshape(b, -1)
    targets = y.reshape(b, -1).to(logits.dtype)
    if row_weights is not None:
        per_image = _bce_with_logits(logits, targets).sum(dim=1)
        return -(row_weights @ per_image.to(row_weights.dtype))
    return -_bce_with_logits(logits, targets).mean() * targets.shape[1]
