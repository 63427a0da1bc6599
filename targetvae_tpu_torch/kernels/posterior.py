"""Fused joint posterior, forward (K3): softmax + Gumbel sample + moments + KL.

Port of targetvae_tpu/kernels/posterior.py::fused_posterior (the forward of
its `_call`). For each image, over its (R, M) cell planes, in float32:

  q        = log_softmax(attn)                       (joint posterior)
  a        = softmax(attn + Gumbel noise), or e^q when deterministic
  E_a[z_mu], E_a[z_std], E_a[theta_mu], E_a[theta_std], std = exp(logstd)+1e-6
  dx       = E_a[grid coordinate] (a marginalised over R)
  kl       = sum e^q (q - log p(t,r))
           + sum e^q (KL(q(theta|t,r) || N(offset_r, sig_r))
                      + sum_d KL(q(z_d|t,r) || N(0,1)))     [guarded where e^q == 0]

Only per-image scalars leave the kernel (csrc/posterior.cu). Its Gumbel noise
comes from an in-kernel Philox4x32-10 keyed by seed + image index, so a row
does not depend on how the batch is split: the rows of images i0.. of a batch
equal a call on that slice with seed + i0. It cannot reproduce the TPU's
bits; the plain version draws its noise from a torch.Generator seeded the
same way per image, so the sampled modes agree in distribution only.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ..ops.gumbel import gumbel_noise

_EPS = 1e-6


def _unpack(out: torch.Tensor, zd: int) -> dict:
    return {
        "z_mu_e": out[:, :zd],
        "z_std_e": out[:, zd:2 * zd],
        "theta_mu_e": out[:, 2 * zd],
        "theta_std_e": out[:, 2 * zd + 1],
        "dx": out[:, 2 * zd + 2:2 * zd + 4],
        "kl": out[:, 2 * zd + 4],
    }


def posterior_plain(attn, theta_mu, theta_logstd, z_mu, z_logstd, p_tr, grid,
                    offsets, sig_r: float,
                    noise: Optional[torch.Tensor] = None) -> dict:
    """Plain PyTorch version. noise: (B, R, M) Gumbel noise for the sample,
    or None for the deterministic a = e^q."""
    b = attn.shape[0]
    flat = attn.reshape(b, -1)
    q = torch.log_softmax(flat, dim=1).reshape(attn.shape)
    eq = torch.softmax(flat, dim=1).reshape(attn.shape)
    if noise is None:
        a = eq
    else:
        a = torch.softmax((attn + noise).reshape(b, -1), dim=1).reshape(attn.shape)
    a_locs = a.sum(dim=1)                                        # (B, M)
    dx = a_locs @ grid
    th_std = torch.exp(theta_logstd) + _EPS
    z_std = torch.exp(z_logstd) + _EPS
    dead = eq == 0.0
    offs = offsets.reshape(1, -1, 1)
    tq_mu = torch.where(dead, 0.0, theta_mu)
    tq_std = torch.where(dead, 1.0, th_std)
    kl_th = (torch.log(sig_r / tq_std)
             + (tq_std * tq_std + (tq_mu - offs) ** 2) / (2.0 * sig_r * sig_r)
             - 0.5)
    zq_mu = torch.where(dead[:, None], 0.0, z_mu)
    zq_std = torch.where(dead[:, None], 1.0, z_std)
    kl_z = (-torch.log(zq_std) + 0.5 * (zq_std * zq_std + zq_mu * zq_mu)
            - 0.5).sum(dim=1)
    kl = ((eq * (q - p_tr)).sum(dim=(1, 2))
          + (eq * (kl_th + kl_z)).sum(dim=(1, 2)))
    return {
        "z_mu_e": torch.einsum("brm,bdrm->bd", a, z_mu),
        "z_std_e": torch.einsum("brm,bdrm->bd", a, z_std),
        "theta_mu_e": (a * theta_mu).sum(dim=(1, 2)),
        "theta_std_e": (a * th_std).sum(dim=(1, 2)),
        "dx": dx, "kl": kl,
    }


def per_image_gumbel(seed: int, shape, device=None) -> torch.Tensor:
    """(B, *shape) Gumbel noise, image i from a generator seeded seed + i —
    the plain version's counterpart of the kernel's per-image Philox keys."""
    b = shape[0]
    return torch.stack([
        gumbel_noise(tuple(shape[1:]), torch.Generator().manual_seed(seed + i))
        for i in range(b)]).to(device)


def fused_posterior(seed: int, attn, theta_mu, theta_logstd, z_mu, z_logstd,
                    p_tr, grid, offsets, sig_r: float, *,
                    deterministic: bool = False) -> dict:
    """attn (B, R, M) logits incl. log p(r); theta_* (B, R, M) (mu incl.
    offsets); z_* (B, zd, R, M); p_tr (R, M) log p(t, r); grid (M, 2);
    offsets (R,); sig_r the conditional prior std; seed an int.

    Returns z_mu_e/z_std_e (B, zd), theta_mu_e/theta_std_e (B,), dx (B, 2),
    kl (B,). A CPU attn takes the plain version; a CUDA one launches
    csrc/posterior.cu."""
    if attn.device.type == "cpu":
        noise = (None if deterministic
                 else per_image_gumbel(seed, attn.shape, attn.device))
        return posterior_plain(attn, theta_mu, theta_logstd, z_mu, z_logstd,
                               p_tr, grid, offsets, sig_r, noise=noise)
    b, r, m = attn.shape
    zd = z_mu.shape[1]
    if zd > 8:
        raise ValueError(f"posterior kernel supports z_dim <= 8, got {zd}")
    f32 = torch.float32
    c = lambda t: t.to(f32).contiguous()
    args = (c(attn), c(theta_mu), c(theta_logstd), c(z_mu), c(z_logstd),
            c(p_tr), c(grid[:, 0]), c(grid[:, 1]), c(offsets))
    _build.check_cuda(*args, dtypes=(f32,) * len(args))
    for name, t, shape in (("theta_mu", args[1], (b, r, m)),
                           ("theta_logstd", args[2], (b, r, m)),
                           ("z_mu", args[3], (b, zd, r, m)),
                           ("z_logstd", args[4], (b, zd, r, m)),
                           ("p_tr", args[5], (r, m)), ("grid x", args[6], (m,)),
                           ("offsets", args[8], (r,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    out = torch.empty((b, 2 * zd + 5), dtype=f32, device=attn.device)
    if b:
        _build.launch("tvae_posterior_fwd", *(t.data_ptr() for t in args),
                      out.data_ptr(), b, r, m, zd, float(sig_r),
                      int(deterministic), int(seed) & 0x7FFFFFFF,
                      torch.cuda.current_stream(attn.device).cuda_stream)
        fused_posterior.launches += 1
    return _unpack(out, zd)


fused_posterior.launches = 0
