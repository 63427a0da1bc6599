"""Reconstruction likelihood heads (mirror of targetvae_tpu/losses/likelihoods.py).

Bernoulli (BCE-with-logits, reference train_mnist.py:286-292 and the RGB
variant train_galaxy.py:286-291), and Gaussian / heteroscedastic Gaussian
with optional per-particle CTF and circular masking (reference
train_particles.py:284-341). Images are channels-last (B, H, W, C); the
generator output is pixel-major (B, N, n_out), so y_hat[b, n, c] pairs with
the pixel value at (n, c).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE-with-logits, the numerically stable form."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def ctf_apply(y_img: torch.Tensor, ctf: torch.Tensor) -> torch.Tensor:
    """Each image cross-correlated with its own real-space CTF kernel, 'same'
    size: what the reference's grouped F.conv2d (groups=B, padding kc // 2,
    train_particles.py:298-302) and the JAX package's exact ctf_apply
    compute. y_img (B, n, n), ctf (B, kc, kc) with kc odd.

    By FFT: both zero-padded to S = n + kc - 1 (no circular wrap), rfft2,
    multiplied, irfft2, cropped to [pad, pad + n). A product of spectra is a
    convolution, so the kernel is flipped once to make it the correlation.
    float32 / complex64 on both tiers."""
    b, n, _ = y_img.shape
    kc = ctf.shape[-1]
    pad = kc // 2
    s = (n + kc - 1,) * 2
    yf = torch.fft.rfft2(y_img.float(), s=s)
    kf = torch.fft.rfft2(torch.flip(ctf.float(), dims=(-2, -1)), s=s)
    out = torch.fft.irfft2(yf * kf, s=s)
    return out[:, pad:pad + n, pad:pad + n]


@functools.lru_cache(maxsize=16)
def _mask_grid(n: int, device: torch.device) -> torch.Tensor:
    """The reference's pixel grid (n*n, 2), x: arange(-n//2, n - n//2),
    y: arange(n//2, n//2 - n, -1); the reference's y range yields n - 1
    values for odd n, this form n (the JAX package's fix)."""
    x_img = np.arange(-(n // 2), n - (n // 2), 1, dtype=np.float32)
    y_img = np.arange(n // 2, n // 2 - n, -1, dtype=np.float32)
    xg, yg = np.meshgrid(x_img, y_img)
    with torch.inference_mode(False):
        return torch.as_tensor(np.stack([xg.ravel(), yg.ravel()], 1),
                               device=device)


def circular_mask(dx: torch.Tensor, n: int, radius: int,
                  btw_pixels_space: float) -> torch.Tensor:
    """Boolean mask (B, n*n): the pixels within `radius` of the inferred
    centre dx / btw_pixels_space (reference train_particles.py:309-333), on
    the device. No gradient flows through it (dx detached, as the reference
    detaches)."""
    grid = _mask_grid(n, dx.device)
    center = dx.detach().float() / btw_pixels_space             # (B, 2)
    d2 = ((center[:, None, :] - grid[None]) ** 2).sum(dim=-1)
    return torch.sqrt(d2) < radius


def reconstruction_log_prob(y_hat: torch.Tensor, y: torch.Tensor,
                            kind: str, fit_noise: bool = False,
                            ctf: Optional[torch.Tensor] = None,
                            dx: Optional[torch.Tensor] = None,
                            mask_radius: int = 0,
                            btw_pixels_space: float = 0.0,
                            row_weights: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Batch-mean reconstruction log-likelihood. y_hat (B, N, n_out)
    generator output; y (B, H, W, C) targets.

    Bernoulli: -BCE_mean * pixels (reference train_mnist.py:291; RGB's
    N * 3, train_galaxy.py:289-291). Gaussian: -0.5 * sum of squared
    errors, with fit_noise (n_out 2) divided by y_var = exp(logvar) plus
    logvar; with ctf (B, kc, kc) the mean, and the variance, are
    CTF-filtered (ctf_apply) while the + logvar term keeps the logvar from
    before the filter (the reference's pairing, train_particles.py:295-307,
    336); the filtered variance may go negative where the kernel's lobes
    are, as there. mask_radius > 0 scores only the pixels within it of dx.

    row_weights: optional (B,) per-image weights. When given, the batch mean
    becomes the weighted SUM of per-image log-likelihoods; the caller owns
    the normalisation (1/n_real over the real rows of a zero-weight-padded
    tail batch, train/loop.py)."""
    b = y.shape[0]
    if kind == "bernoulli":
        logits = y_hat.reshape(b, -1)
        targets = y.reshape(b, -1).to(logits.dtype)
        if row_weights is not None:
            per_image = _bce_with_logits(logits, targets).sum(dim=1)
            return -(row_weights @ per_image.to(row_weights.dtype))
        return -_bce_with_logits(logits, targets).mean() * targets.shape[1]
    if kind != "gaussian":
        raise ValueError(f"unknown likelihood {kind!r}")

    n = y.shape[1]
    y_flat = y.reshape(b, -1).float()
    y_mu = y_hat[..., 0].reshape(b, -1).float()
    y_var = y_logvar = None
    if fit_noise:
        y_logvar = y_hat[..., 1].reshape(b, -1).float()
        y_var = torch.exp(y_logvar)

    if ctf is not None:
        y_mu = ctf_apply(y_mu.reshape(b, n, n), ctf).reshape(b, -1)
        if y_var is not None:
            y_var = ctf_apply(y_var.reshape(b, n, n), ctf).reshape(b, -1)

    mask = None
    if mask_radius > 0:
        if dx is None:
            raise ValueError("mask_radius > 0 needs the translations dx")
        mask = circular_mask(dx, n, mask_radius, btw_pixels_space)
        y_flat = torch.where(mask, y_flat, 0.0)
        y_mu = torch.where(mask, y_mu, 0.0)

    if y_var is not None:
        term = (y_mu - y_flat) ** 2 / y_var + y_logvar
        if mask is not None:
            term = torch.where(mask, term, 0.0)
        per_row = term.sum(dim=1)
    else:
        per_row = ((y_mu - y_flat) ** 2).sum(dim=1)
    if row_weights is not None:
        return -0.5 * (row_weights @ per_row)
    return -0.5 * per_row.mean()
