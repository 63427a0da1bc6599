"""Fused joint posterior (K3 forward, K4 backward) and its grid-sharded
variant (K5 forward, K6 backward).

K3/K4 port targetvae_tpu/kernels/posterior.py::fused_posterior (its `_call`,
forward and backward). For each image, over its (R, M) cell planes, in
float32:

  q        = log_softmax(attn)                       (joint posterior)
  a        = softmax(attn + Gumbel noise), or e^q when deterministic
  E_a[z_mu], E_a[z_std], E_a[theta_mu], E_a[theta_std], std = exp(logstd)+1e-6
  dx       = E_a[grid coordinate] (a marginalised over R)
  kl       = sum e^q (q - log p(t,r))
           + sum e^q (KL(q(theta|t,r) || N(offset_r, sig_r))
                      + sum_d KL(q(z_d|t,r) || N(0,1)))     [guarded where e^q == 0]

Only per-image scalars leave the kernel (csrc/posterior.cu), packed as
(B, 2*zd + 5). Its Gumbel noise comes from an in-kernel Philox4x32-10 keyed
by seed + image index, so a row does not depend on how the batch is split:
the rows of images i0.. of a batch equal a call on that slice with seed + i0.
It cannot reproduce the TPU's bits; the plain version draws its noise from a
torch.Generator seeded the same way per image, so the sampled modes agree in
distribution only.

The backward (K4) recomputes the forward, noise included, from the seed the
forward was given: _Posterior saves the seed, not the noise, and returns the
packed output so that its cotangent arrives packed.

K5/K6 port posterior_shard_partials: the same sums over one shard of the
cell axis, under global softmax normalisers that the caller computed across
ranks (parallel/grid_softmax.py::sp_posterior_kernel), with explicit noise
and per-cell constants; see posterior_shard_partials.
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


def _pack(d: dict) -> torch.Tensor:
    return torch.cat([d["z_mu_e"], d["z_std_e"], d["theta_mu_e"][:, None],
                      d["theta_std_e"][:, None], d["dx"], d["kl"][:, None]],
                     dim=1)


def _kl_terms(eq, theta_mu, th_std, z_mu, z_std, offs, sig_r):
    """The guarded per-cell KLs of theta and of z summed over d: theta planes
    (B, ...), z planes (B, zd, ...), offs broadcast against the theta planes.
    At a dead cell (e^q == 0) the moments are replaced by (0, 1)."""
    dead = eq == 0.0
    tq_mu = torch.where(dead, 0.0, theta_mu)
    tq_std = torch.where(dead, 1.0, th_std)
    kl_th = (torch.log(sig_r / tq_std)
             + (tq_std * tq_std + (tq_mu - offs) ** 2) / (2.0 * sig_r * sig_r)
             - 0.5)
    zq_mu = torch.where(dead[:, None], 0.0, z_mu)
    zq_std = torch.where(dead[:, None], 1.0, z_std)
    kl_z = (-torch.log(zq_std) + 0.5 * (zq_std * zq_std + zq_mu * zq_mu)
            - 0.5).sum(dim=1)
    return kl_th, kl_z


def _moment_grads(g_thmu, g_thstd, g_zmu, g_zstd, g_kl, eq, a, theta_mu,
                  th_std, z_mu, z_std, offs, sig_r):
    """The theta and z planes' cotangents: g . a, plus at live cells
    g_kl e^q times the guarded KL's derivative; the log-std planes chained
    through exp. Shapes as _kl_terms; g_z* broadcast against the z planes.
    Returns d theta_mu, d theta_logstd, d z_mu, d z_logstd."""
    scale = g_kl * eq
    live = eq != 0.0
    s2 = sig_r * sig_r
    d_thmu = g_thmu * a + torch.where(live, scale * (theta_mu - offs) / s2, 0.0)
    d_thstd = g_thstd * a + torch.where(
        live, scale * (th_std / s2 - 1.0 / th_std), 0.0)
    d_zm = g_zmu * a[:, None] + torch.where(live[:, None],
                                            scale[:, None] * z_mu, 0.0)
    d_zs = g_zstd * a[:, None] + torch.where(
        live[:, None], scale[:, None] * (z_std - 1.0 / z_std), 0.0)
    return (d_thmu, d_thstd * (th_std - _EPS), d_zm, d_zs * (z_std - _EPS))


def _posterior_core(attn, noise):
    b = attn.shape[0]
    flat = attn.reshape(b, -1)
    q = torch.log_softmax(flat, dim=1).reshape(attn.shape)
    eq = torch.softmax(flat, dim=1).reshape(attn.shape)
    if noise is None:
        return q, eq, eq
    a = torch.softmax((attn + noise).reshape(b, -1), dim=1).reshape(attn.shape)
    return q, eq, a


def posterior_plain(attn, theta_mu, theta_logstd, z_mu, z_logstd, p_tr, grid,
                    offsets, sig_r: float,
                    noise: Optional[torch.Tensor] = None) -> dict:
    """Plain PyTorch version. noise: (B, R, M) Gumbel noise for the sample,
    or None for the deterministic a = e^q."""
    q, eq, a = _posterior_core(attn, noise)
    dx = a.sum(dim=1) @ grid                                     # (B, 2)
    th_std = torch.exp(theta_logstd) + _EPS
    z_std = torch.exp(z_logstd) + _EPS
    kl_th, kl_z = _kl_terms(eq, theta_mu, th_std, z_mu, z_std,
                            offsets.reshape(1, -1, 1), sig_r)
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


def _check_shapes(named) -> None:
    for name, t, shape in named:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {tuple(shape)}, "
                             f"got {tuple(t.shape)}")


def _check_zd(zd: int) -> None:
    if zd > 8:
        raise ValueError(f"posterior kernels support z_dim <= 8, got {zd}")


def _cuda_args(attn, theta_mu, theta_logstd, z_mu, z_logstd, p_tr, grid,
               offsets):
    b, r, m = attn.shape
    zd = z_mu.shape[1]
    _check_zd(zd)
    f32 = torch.float32
    c = lambda t: t.to(f32).contiguous()
    args = (c(attn), c(theta_mu), c(theta_logstd), c(z_mu), c(z_logstd),
            c(p_tr), c(grid[:, 0]), c(grid[:, 1]), c(offsets))
    _build.check_cuda(*args, dtypes=(f32,) * len(args))
    _check_shapes((("theta_mu", args[1], (b, r, m)),
                   ("theta_logstd", args[2], (b, r, m)),
                   ("z_mu", args[3], (b, zd, r, m)),
                   ("z_logstd", args[4], (b, zd, r, m)),
                   ("p_tr", args[5], (r, m)), ("grid x", args[6], (m,)),
                   ("offsets", args[8], (r,))))
    return args


def posterior_fwd(seed: int, attn, theta_mu, theta_logstd, z_mu, z_logstd,
                  p_tr, grid, offsets, sig_r: float, *,
                  deterministic: bool = False) -> torch.Tensor:
    """The packed forward (B, 2*zd + 5): [z_mu_e, z_std_e, theta_mu_e,
    theta_std_e, dx, kl]. A CPU attn takes the plain version; a CUDA one
    launches csrc/posterior.cu."""
    if attn.device.type == "cpu":
        noise = (None if deterministic
                 else per_image_gumbel(seed, attn.shape, attn.device))
        return _pack(posterior_plain(attn, theta_mu, theta_logstd, z_mu,
                                     z_logstd, p_tr, grid, offsets, sig_r,
                                     noise=noise))
    args = _cuda_args(attn, theta_mu, theta_logstd, z_mu, z_logstd, p_tr,
                      grid, offsets)
    b, r, m = attn.shape
    zd = z_mu.shape[1]
    out = torch.empty((b, 2 * zd + 5), dtype=torch.float32, device=attn.device)
    if b:
        _build.launch("tvae_posterior_fwd", *(t.data_ptr() for t in args),
                      out.data_ptr(), b, r, m, zd, float(sig_r),
                      int(deterministic), int(seed) & 0x7FFFFFFF,
                      torch.cuda.current_stream(attn.device).cuda_stream)
        posterior_fwd.launches += 1
    return out


posterior_fwd.launches = 0


def posterior_bwd_plain(g, attn, theta_mu, theta_logstd, z_mu, z_logstd,
                        p_tr, grid, offsets, sig_r: float,
                        noise: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the backward (the hand-derived VJP of
    targetvae_tpu/kernels/posterior.py::_bwd_one). g (B, 2*zd + 5) is the
    packed cotangent. Returns dattn, dtheta_mu, dtheta_logstd (B, R, M) and
    dz_mu, dz_logstd (B, zd, R, M)."""
    zd = z_mu.shape[1]
    q, eq, a = _posterior_core(attn, noise)
    th_std = torch.exp(theta_logstd) + _EPS
    z_std = torch.exp(z_logstd) + _EPS
    col = lambda i: g[:, i, None, None]                          # (B, 1, 1)
    g_zmu, g_zstd = g[:, :zd, None, None], g[:, zd:2 * zd, None, None]
    g_thmu, g_thstd, g_kl = col(2 * zd), col(2 * zd + 1), col(2 * zd + 4)
    d_a = (g_thmu * theta_mu + g_thstd * th_std
           + (col(2 * zd + 2) * grid[:, 0] + col(2 * zd + 3) * grid[:, 1])
           + (g_zmu * z_mu + g_zstd * z_std).sum(dim=1))
    offs = offsets.reshape(1, -1, 1)
    kl_th, kl_z = _kl_terms(eq, theta_mu, th_std, z_mu, z_std, offs, sig_r)
    d_q = g_kl * eq * ((q - p_tr) + 1.0 + (kl_th + kl_z))
    d_attn = (a * (d_a - (d_a * a).sum(dim=(1, 2), keepdim=True))
              + d_q - eq * d_q.sum(dim=(1, 2), keepdim=True))
    return (d_attn, *_moment_grads(g_thmu, g_thstd, g_zmu, g_zstd, g_kl, eq,
                                   a, theta_mu, th_std, z_mu, z_std, offs,
                                   sig_r))


def posterior_bwd(seed: int, g, attn, theta_mu, theta_logstd, z_mu, z_logstd,
                  p_tr, grid, offsets, sig_r: float, *,
                  deterministic: bool = False):
    """The backward of posterior_fwd (K4) at the same seed, with the outputs
    of posterior_bwd_plain. A CPU attn takes the plain version (its noise
    regenerated by per_image_gumbel from the seed); a CUDA one launches
    csrc/posterior.cu, which regenerates the forward's Philox bits."""
    if attn.device.type == "cpu":
        noise = (None if deterministic
                 else per_image_gumbel(seed, attn.shape, attn.device))
        return posterior_bwd_plain(g, attn, theta_mu, theta_logstd, z_mu,
                                   z_logstd, p_tr, grid, offsets, sig_r,
                                   noise=noise)
    args = _cuda_args(attn, theta_mu, theta_logstd, z_mu, z_logstd, p_tr,
                      grid, offsets)
    b, r, m = attn.shape
    zd = z_mu.shape[1]
    g = g.to(torch.float32).contiguous()
    _build.check_cuda(args[0], g, dtypes=(torch.float32,) * 2)
    _check_shapes((("g", g, (b, 2 * zd + 5)),))
    grads = tuple(torch.empty_like(t) for t in args[:5])
    if b:
        _build.launch("tvae_posterior_bwd", *(t.data_ptr() for t in args),
                      g.data_ptr(), *(t.data_ptr() for t in grads),
                      b, r, m, zd, float(sig_r), int(deterministic),
                      int(seed) & 0x7FFFFFFF,
                      torch.cuda.current_stream(attn.device).cuda_stream)
        posterior_bwd.launches += 1
    return grads


posterior_bwd.launches = 0


class _Posterior(torch.autograd.Function):
    """K3 forward, K4 backward at the saved seed. Gradients for attn and the
    theta and z planes; p_tr, grid and offsets are constants."""

    @staticmethod
    def forward(ctx, attn, theta_mu, theta_logstd, z_mu, z_logstd, p_tr, grid,
                offsets, sig_r, seed, deterministic):
        ctx.save_for_backward(attn, theta_mu, theta_logstd, z_mu, z_logstd,
                              p_tr, grid, offsets)
        ctx.cfg = (sig_r, seed, deterministic)
        return posterior_fwd(seed, attn, theta_mu, theta_logstd, z_mu,
                             z_logstd, p_tr, grid, offsets, sig_r,
                             deterministic=deterministic)

    @staticmethod
    def backward(ctx, g):
        sig_r, seed, deterministic = ctx.cfg
        grads = posterior_bwd(seed, g, *ctx.saved_tensors, sig_r,
                              deterministic=deterministic)
        return (*grads, None, None, None, None, None, None)


def fused_posterior(seed: int, attn, theta_mu, theta_logstd, z_mu, z_logstd,
                    p_tr, grid, offsets, sig_r: float, *,
                    deterministic: bool = False) -> dict:
    """attn (B, R, M) logits incl. log p(r); theta_* (B, R, M) (mu incl.
    offsets); z_* (B, zd, R, M); p_tr (R, M) log p(t, r); grid (M, 2);
    offsets (R,); sig_r the conditional prior std; seed an int.

    Returns z_mu_e/z_std_e (B, zd), theta_mu_e/theta_std_e (B,), dx (B, 2),
    kl (B,); differentiable in attn and the theta and z planes through K4.
    The Function keeps only references to its inputs and the seed, so the
    serving path (no gradient) pays nothing for it."""
    out = _Posterior.apply(attn, theta_mu, theta_logstd, z_mu, z_logstd, p_tr,
                           grid, offsets, sig_r, seed, deterministic)
    return _unpack(out, z_mu.shape[1])


# ---------------------------------------------------------------------------
# grid-sharded (SP) variant: one cell shard's partials under global
# normalisers (K5 forward, K6 backward)
# ---------------------------------------------------------------------------
# Port of targetvae_tpu/kernels/posterior.py::posterior_shard_partials
# (_sp_fwd_kernel, _sp_bwd_kernel). Inputs are flat cell shards: attn, noise
# (B, C); th (B, 2, C) = [mu, logstd]; z (B, 2, zd, C); p, gx, gy, offs (C,)
# per-cell constants of the shard (p globally log-softmaxed); norms (B, 4) =
# [gmax_q, g_logsum_q, gmax_a, g_logsum_a]. Padded cells carry -1e30 logits:
# exp underflows to exactly 0, the dead-cell guards neutralise their
# moments, and every partial and gradient they contribute is exactly 0. The
# TPU kernel's (C // 128, 128) view and its C % 1024 == 0 requirement are
# TPU tiling; these take any C.


def _shard_core(norms, attn, noise):
    q = attn - norms[:, 0:1] - norms[:, 1:2]             # log q, globally normed
    return q, torch.exp(q), torch.exp(attn + noise - norms[:, 2:3]
                                      - norms[:, 3:4])


def _shard_planes(th, z):
    return (th[:, 0], torch.exp(th[:, 1]) + _EPS, z[:, 0],
            torch.exp(z[:, 1]) + _EPS)


def posterior_shard_plain(norms, attn, noise, th, z, p, gx, gy, offs,
                          sig_r: float) -> torch.Tensor:
    """Plain PyTorch version of K5: the shard's (B, 2*zd + 5) partial sums
    [z_mu_e, z_std_e, theta_mu_e, theta_std_e, dx0, dx1, kl]."""
    q, eq, a = _shard_core(norms, attn, noise)
    th_mu, th_std, z_mu, z_std = _shard_planes(th, z)
    kl_th, kl_z = _kl_terms(eq, th_mu, th_std, z_mu, z_std, offs, sig_r)
    s = lambda v: (a * v).sum(dim=-1)
    sz = lambda v: (a[:, None] * v).sum(dim=-1)                   # (B, zd)
    kl = (eq * (q - p)).sum(dim=1) + (eq * (kl_th + kl_z)).sum(dim=1)
    return torch.cat([sz(z_mu), sz(z_std), torch.stack(
        [s(th_mu), s(th_std), s(gx), s(gy), kl], dim=1)], dim=1)


def posterior_shard_bwd_plain(norms, attn, noise, th, z, p, gx, gy, offs,
                              sig_r: float, g):
    """Plain PyTorch version of K6, phase 1 of the shard's VJP under the
    TOTAL cotangent g (B, 2*zd + 5): d_a and d_q (B, C), the theta and z
    planes' cotangents (B, 2, C) and (B, 2, zd, C), and spart (B, 2), the
    local softmax-VJP sums [sum d_a a, sum d_q] the caller all-reduces."""
    zd = z.shape[2]
    q, eq, a = _shard_core(norms, attn, noise)
    th_mu, th_std, z_mu, z_std = _shard_planes(th, z)
    col = lambda i: g[:, i:i + 1]                                # (B, 1)
    g_zmu, g_zstd = g[:, :zd, None], g[:, zd:2 * zd, None]       # (B, zd, 1)
    g_thmu, g_thstd, g_kl = col(2 * zd), col(2 * zd + 1), col(2 * zd + 4)
    d_a = (g_thmu * th_mu + g_thstd * th_std + col(2 * zd + 2) * gx
           + col(2 * zd + 3) * gy + (g_zmu * z_mu + g_zstd * z_std).sum(dim=1))
    kl_th, kl_z = _kl_terms(eq, th_mu, th_std, z_mu, z_std, offs, sig_r)
    d_q = g_kl * eq * ((q - p) + 1.0 + (kl_th + kl_z))
    d_thmu, d_thls, d_zm, d_zls = _moment_grads(
        g_thmu, g_thstd, g_zmu, g_zstd, g_kl, eq, a, th_mu, th_std, z_mu,
        z_std, offs, sig_r)
    spart = torch.stack([(d_a * a).sum(dim=1), d_q.sum(dim=1)], dim=1)
    return (d_a, d_q, torch.stack([d_thmu, d_thls], dim=1),
            torch.stack([d_zm, d_zls], dim=1), spart)


def _shard_cuda_args(norms, attn, noise, th, z, p, gx, gy, offs):
    b, c = attn.shape
    zd = z.shape[2]
    _check_zd(zd)
    f32 = torch.float32
    args = tuple(t.to(f32).contiguous()
                 for t in (norms, attn, noise, th, z, p, gx, gy, offs))
    _build.check_cuda(*args, dtypes=(f32,) * len(args))
    _check_shapes((("norms", args[0], (b, 4)), ("noise", args[2], (b, c)),
                   ("th", args[3], (b, 2, c)), ("z", args[4], (b, 2, zd, c)),
                   ("p", args[5], (c,)), ("gx", args[6], (c,)),
                   ("gy", args[7], (c,)), ("offs", args[8], (c,))))
    return args


def posterior_shard_fwd(norms, attn, noise, th, z, p, gx, gy, offs,
                        sig_r: float) -> torch.Tensor:
    """K5: the shard's (B, 2*zd + 5) partial sums. A CPU attn takes the
    plain version; a CUDA one launches csrc/posterior.cu."""
    if attn.device.type == "cpu":
        return posterior_shard_plain(norms, attn, noise, th, z, p, gx, gy,
                                     offs, sig_r)
    args = _shard_cuda_args(norms, attn, noise, th, z, p, gx, gy, offs)
    b, c = attn.shape
    zd = z.shape[2]
    out = torch.empty((b, 2 * zd + 5), dtype=torch.float32, device=attn.device)
    if b:
        _build.launch("tvae_posterior_shard_fwd",
                      *(t.data_ptr() for t in args), out.data_ptr(), b, c, zd,
                      float(sig_r),
                      torch.cuda.current_stream(attn.device).cuda_stream)
        posterior_shard_fwd.launches += 1
    return out


posterior_shard_fwd.launches = 0


def posterior_shard_bwd(norms, attn, noise, th, z, p, gx, gy, offs,
                        sig_r: float, g):
    """K6, with the outputs of posterior_shard_bwd_plain. A CPU attn takes
    the plain version; a CUDA one launches csrc/posterior.cu."""
    if attn.device.type == "cpu":
        return posterior_shard_bwd_plain(norms, attn, noise, th, z, p, gx, gy,
                                         offs, sig_r, g)
    args = _shard_cuda_args(norms, attn, noise, th, z, p, gx, gy, offs)
    b, c = attn.shape
    zd = z.shape[2]
    g = g.to(torch.float32).contiguous()
    _build.check_cuda(args[1], g, dtypes=(torch.float32,) * 2)
    _check_shapes((("g", g, (b, 2 * zd + 5)),))
    outs = (torch.empty_like(args[1]), torch.empty_like(args[1]),
            torch.empty_like(args[3]), torch.empty_like(args[4]),
            torch.empty((b, 2), dtype=torch.float32, device=attn.device))
    if b:
        _build.launch("tvae_posterior_shard_bwd",
                      *(t.data_ptr() for t in args), g.data_ptr(),
                      *(t.data_ptr() for t in outs), b, c, zd, float(sig_r),
                      torch.cuda.current_stream(attn.device).cuda_stream)
        posterior_shard_bwd.launches += 1
    return outs


posterior_shard_bwd.launches = 0


def posterior_shard_partials(norms, attn, noise, th, z, p, gx, gy, offs, *,
                             sig_r: float, zd: int, want_grads: bool = False,
                             g=None):
    """The per-shard posterior kernels with the JAX package's contract (no
    autograd: the VJP lives at the collective level,
    parallel/grid_softmax.py::sp_posterior_kernel).

    norms (B, 4): [gmax_q, g_logsum_q, gmax_a, g_logsum_a] global softmax
    normalisers per image. attn/noise (B, C); th (B, 2, C); z (B, 2, zd, C);
    p/gx/gy/offs (C,) per-cell constants of the LOCAL shard (p globally
    log-softmaxed).

    Forward: (B, 2zd+5) local partial sums (all-reduce to finish).
    Backward (want_grads=True, g (B, 2zd+5) TOTAL cotangent): returns
    (d_a, d_q, d_th, d_z, spart) where spart (B, 2) holds the local
    [sum(d_a*a), sum(d_q)] softmax-VJP partials."""
    if z.shape[2] != zd:
        raise ValueError(f"z carries z_dim {z.shape[2]}, not {zd}")
    if not want_grads:
        return posterior_shard_fwd(norms, attn, noise, th, z, p, gx, gy, offs,
                                   sig_r)
    return posterior_shard_bwd(norms, attn, noise, th, z, p, gx, gy, offs,
                               sig_r, g)
