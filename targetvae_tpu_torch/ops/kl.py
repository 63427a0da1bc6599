"""Gaussian KL helpers with the reference's NaN guards
(mirror of targetvae_tpu/ops/kl.py).

guarded_moments replicates the torch.where guards at reference
train_mnist.py:154-163, 245-254: wherever exp(q) underflows to 0 the
posterior moments become (0, 1), so 0 * KL stays 0 instead of 0 * inf = NaN.
"""

from __future__ import annotations

import torch


def normal_kl(mu_q: torch.Tensor, std_q: torch.Tensor, mu_p, std_p) -> torch.Tensor:
    """KL(N(mu_q, std_q) || N(mu_p, std_p)), elementwise."""
    mu_p = torch.as_tensor(mu_p, dtype=mu_q.dtype, device=mu_q.device)
    std_p = torch.as_tensor(std_p, dtype=mu_q.dtype, device=mu_q.device)
    var_ratio = (std_q / std_p) ** 2
    t1 = ((mu_q - mu_p) / std_p) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def guarded_moments(q_log: torch.Tensor, mu: torch.Tensor, std: torch.Tensor):
    """Where exp(q_log) == 0, replace (mu, std) by (0, 1); q_log broadcasts."""
    dead = torch.exp(q_log) == 0.0
    mu = torch.where(dead, torch.zeros_like(mu), mu)
    std = torch.where(dead, torch.ones_like(std), std)
    return mu, std
