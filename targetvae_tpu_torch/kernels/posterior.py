"""Fused joint posterior (K3 forward, K4 backward) and its grid-sharded
variant (K5 forward, K6 backward).

K3/K4 port targetvae_tpu/kernels/posterior.py::fused_posterior (its `_call`,
forward and backward), for mode C (R in 4, 8, 16) and mode B (R = 1, whose
images of M cells need not come in fours: the kernels mask the ragged
edges). They take the encoder's raw heads where the encoder kernels leave
them: (B, M, R, D) float32, D = 3 + 2*zd channels [attention
logit, theta mean, theta log-std, z means (zd), z log-stds (zd)] over the
cells m-major, r-minor (the JAX package's flatten), and add the rotation
prior log p(r) to the logit and the offsets to theta's mean themselves. For
each image, over its R*M cells, in float32:

  q        = log_softmax(attn)                       (joint posterior)
  a        = softmax(attn + Gumbel noise), or e^q when deterministic
  E_a[z_mu], E_a[z_std], E_a[theta_mu], E_a[theta_std], std = exp(logstd)+1e-6
  dx       = E_a[grid coordinate] (a marginalised over R)
  kl       = sum e^q (q - log p(t,r))
           + sum e^q (KL(q(theta|t,r) || N(offset_r, sig_r))
                      + sum_d KL(q(z_d|t,r) || N(0,1)))     [guarded where e^q == 0]

Only per-image scalars leave K3 (csrc/posterior.cu), packed as
(B, 2*zd + 5); K4 returns the cotangent of the raw heads in their own
layout, the g the encoder's backward kernels (K2, K12) take. The kernels'
Gumbel noise comes from an in-kernel Philox4x32-10 keyed by seed + image
index with counter r*M + m, so a row does not depend on how the batch is
split: the rows of images i0.. of a batch equal a call on that slice with
seed + i0. philox_gumbel draws the same noise in plain PyTorch, so the card
can hold the sampled kernels against the plain version exactly. It cannot
reproduce the TPU's bits; the CPU tier draws its noise from a
torch.Generator seeded the same way per image (per_image_gumbel), so the
sampled modes of the two tiers agree in distribution only.

The backward (K4) recomputes the forward, noise included, from the seed the
forward was given: _Posterior saves the seed, not the noise, and returns the
packed output so that its cotangent arrives packed.

K5/K6 port posterior_shard_partials: the same sums over one shard of the
cell axis, under global softmax normalisers that the caller computed across
ranks (parallel/grid_softmax.py::sp_posterior), with explicit noise and
per-cell constants. They read the (B, 3 + 2 zd, C) planes the SP step's
batch-to-cell exchange leaves, where they lie, and K6 writes the theta
and z cotangents into the planes' cotangent; posterior_shard_partials
keeps the JAX package's argument contract by packing the planes.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ..ops.gumbel import gumbel_noise

_EPS = 1e-6
# K3: the cells a CTA streams at most (k3_schedule); K4: the bytes of heads
# a CTA holds in shared memory at most, a larger chunk streaming through it
# (k4_schedule)
K3_CELLS = 3072
K3_CELLS_R1 = 1024
HEADS_SMEM_BYTES = 64 * 1024
# K5/K6: the cells a CTA takes at most (shard_schedule)
SHARD_CELLS = 1536
_M32 = 0xFFFFFFFF


def _unpack(out: torch.Tensor, zd: int) -> dict:
    # one split, whose backward is one concatenation of the cotangents
    z_mu_e, z_std_e, th_mu, th_std, dx, kl = out.split(
        [zd, zd, 1, 1, 2, 1], dim=1)
    return {"z_mu_e": z_mu_e, "z_std_e": z_std_e,
            "theta_mu_e": th_mu.squeeze(1), "theta_std_e": th_std.squeeze(1),
            "dx": dx, "kl": kl.squeeze(1)}


def _pack(d: dict) -> torch.Tensor:
    return torch.cat([d["z_mu_e"], d["z_std_e"], d["theta_mu_e"][:, None],
                      d["theta_std_e"][:, None], d["dx"], d["kl"][:, None]],
                     dim=1)


def split_heads(heads, p_r, offsets):
    """The (B, R, M) planes of the raw heads (B, M, R, D), the rotation
    prior added to the logit and the offsets to theta's mean: attn,
    theta_mu, theta_logstd (B, R, M) and z_mu, z_logstd (B, zd, R, M)."""
    zd = (heads.shape[-1] - 3) // 2
    hp = heads.permute(0, 3, 2, 1)                               # (B, D, R, M)
    return (hp[:, 0] + p_r[:, None], hp[:, 1] + offsets[:, None], hp[:, 2],
            hp[:, 3:3 + zd], hp[:, 3 + zd:])


def join_heads(d_attn, d_thmu, d_thls, d_zmu, d_zls) -> torch.Tensor:
    """split_heads' planes' cotangents as the cotangent of the raw heads,
    (B, M, R, D) (p_r and the offsets are constants)."""
    return torch.cat([d_attn[:, None], d_thmu[:, None], d_thls[:, None],
                      d_zmu, d_zls], dim=1).permute(0, 3, 2, 1).contiguous()


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
    flat = attn.flatten(1)
    q = torch.log_softmax(flat, dim=1).reshape(attn.shape)
    eq = torch.softmax(flat, dim=1).reshape(attn.shape)
    if noise is None:
        return q, eq, eq
    a = torch.softmax((attn + noise).flatten(1), dim=1).reshape(attn.shape)
    return q, eq, a


def posterior_plain(heads, p_r, offsets, p_tr, grid, sig_r: float,
                    noise: Optional[torch.Tensor] = None) -> dict:
    """Plain PyTorch version of K3: split_heads, then the planes' formulas.
    p_tr (M, R); noise: (B, R, M) Gumbel noise for the sample, or None for
    the deterministic a = e^q."""
    attn, theta_mu, theta_logstd, z_mu, z_logstd = split_heads(heads, p_r,
                                                               offsets)
    q, eq, a = _posterior_core(attn, noise)
    dx = a.sum(dim=1) @ grid                                     # (B, 2)
    th_std = torch.exp(theta_logstd) + _EPS
    z_std = torch.exp(z_logstd) + _EPS
    kl_th, kl_z = _kl_terms(eq, theta_mu, th_std, z_mu, z_std,
                            offsets.reshape(1, -1, 1), sig_r)
    kl = ((eq * (q - p_tr.T)).sum(dim=(1, 2))
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
    the CPU tier's counterpart of the kernel's per-image Philox keys."""
    rows = [gumbel_noise(tuple(shape[1:]),
                         torch.Generator().manual_seed(seed + i))
            for i in range(shape[0])]
    return (torch.stack(rows) if rows else torch.empty(tuple(shape))).to(device)


def _mulhilo(a: int, b: torch.Tensor):
    """The high and low 32-bit words of the constant a (32 bits) times the
    32-bit values b (an int64 tensor), exact in int64: b times each 16-bit
    half of a stays below 2^48."""
    p1 = b * (a & 0xFFFF)
    p2 = b * (a >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return (s >> 32) + (p2 >> 16), s & _M32


def philox4x32(counter, key):
    """Philox4x32-10 (Random123's philox4x32, csrc/posterior.cu's philox_x)
    in PyTorch integer operations: counter a tuple of four and key a tuple
    of two 32-bit words, each an int64 tensor (they broadcast). Returns the
    four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def philox_gumbel(seed: int, b: int, R: int, M: int,
                  device=None) -> torch.Tensor:
    """(b, R, M) Gumbel noise exactly as K3 and K4 draw it for images 0..b-1
    of a call with this seed: image i keyed by (seed & 0x7FFFFFFF) + i,
    cell (r, m) countered r*M + m; the uniform takes the first word's top 23
    bits as a [1, 2) mantissa minus 1, clipped to [1e-20, 1 - 1e-7]."""
    key = ((int(seed) & 0x7FFFFFFF)
           + torch.arange(b, dtype=torch.int64, device=device))[:, None] & _M32
    ctr = torch.arange(R * M, dtype=torch.int64, device=device)[None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    bits = philox4x32((ctr, zero, zero, zero), (key, zero))[0]
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = u.clamp(1e-20, 1.0 - 1e-7)
    return (-torch.log(-torch.log(u))).reshape(b, R, M)


def _check_shapes(named) -> None:
    for name, t, shape in named:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {tuple(shape)}, "
                             f"got {tuple(t.shape)}")


def posterior_kernel_supported(ecfg) -> bool:
    """Whether K3/K4 take this encoder config: z_dim <= 8 (their templates),
    and mode C with R in (4, 8, 16) or mode B (R = 1). compute_elbo's bf16
    tier runs the JAX package's bf16 path (encoder_apply, then the
    posterior in plain PyTorch) otherwise; the route is chosen from the
    config before any launch."""
    return ecfg.z_dim <= 8 and (ecfg.mode == "B" or (
        ecfg.mode == "C" and ecfg.groupconv in (4, 8, 16)))


def k3_schedule(m: int, r: int, cluster: Optional[int] = None):
    """K3's grid for images of r*m cells: (cluster, chunk). An image is a
    cluster of `cluster` CTAs, by default the smallest of 1, 2, 4, 8, 16
    whose chunks hold at most K3_CELLS cells (K3_CELLS_R1 at R = 1, whose
    images are small: mode B's 2,604 cells would leave a lone CTA streaming
    them, 100 CTAs on 132 SMs), else 16; each CTA streams `chunk` cells (a
    multiple of 4). The grid depends on the image's shape alone, so a row
    of a batch does not depend on the batch's size."""
    c = r * m
    ceil4 = lambda n: -(-n // 4) * 4
    cap = K3_CELLS_R1 if r == 1 else K3_CELLS
    if cluster is None:
        cluster = next((k for k in (1, 2, 4, 8, 16)
                        if ceil4(-(-c // k)) <= cap), 16)
    return cluster, ceil4(-(-c // cluster))


def k4_schedule(m: int, r: int, d: int, cluster: Optional[int] = None,
                budget: int = HEADS_SMEM_BYTES):
    """K4's grid for images of r*m cells of d heads: (cluster, chunk, sub).
    An image is a cluster of `cluster` CTAs, by default the smallest of 1,
    2, 4, 8, 16 whose chunks fit `budget` bytes of heads, else 16; each CTA
    takes `chunk` cells (a multiple of 4), at most `sub` of them in shared
    memory at a time (budget bytes' worth, a multiple of 4; a chunk past it
    streams in sub-chunks). The grid depends on the image's shape alone, so
    a row of a batch does not depend on the batch's size."""
    c, row = r * m, 4 * d
    ceil4 = lambda n: -(-n // 4) * 4
    if cluster is None:
        cluster = next((k for k in (1, 2, 4, 8, 16)
                        if ceil4(-(-c // k)) * row <= budget), 16)
    chunk = ceil4(-(-c // cluster))
    return cluster, chunk, min(chunk, max(4, budget // row // 4 * 4))


def _cuda_args(heads, p_r, offsets, p_tr, grid):
    """The wrappers' checks; returns the float32 tensors, the heads and p_tr
    16-byte aligned for the kernels' bulk copies (a copy of one that is
    not), and (B, M, R, zd)."""
    if heads.dim() != 4 or heads.shape[-1] < 5 or heads.shape[-1] % 2 == 0:
        raise ValueError(f"heads: expected (B, M, R, 3 + 2 zd), got "
                         f"{tuple(heads.shape)}")
    b, m, r, d = heads.shape
    zd = (d - 3) // 2
    if zd > 8:
        raise ValueError(f"K3/K4 take z_dim <= 8, got {zd}")
    if r not in (1, 4, 8, 16):
        raise ValueError(f"posterior kernels take R in (1, 4, 8, 16), got {r}")
    f32 = torch.float32
    args = tuple(t.to(f32).contiguous()
                 for t in (heads, p_r, offsets, p_tr, grid))
    args = tuple(t.clone() if i in (0, 3) and t.data_ptr() % 16 else t
                 for i, t in enumerate(args))
    _build.check_cuda(*args, dtypes=(f32,) * len(args))
    _check_shapes((("p_r", args[1], (r,)), ("offsets", args[2], (r,)),
                   ("p_tr", args[3], (m, r)), ("grid", args[4], (m, 2))))
    return args, (b, m, r, zd)


def posterior_fwd(seed: int, heads, p_r, offsets, p_tr, grid, sig_r: float,
                  *, deterministic: bool = False,
                  schedule: Optional[tuple] = None) -> torch.Tensor:
    """The packed forward (B, 2*zd + 5): [z_mu_e, z_std_e, theta_mu_e,
    theta_std_e, dx, kl]. A CPU heads takes the plain version; a CUDA one
    launches csrc/posterior.cu on k3_schedule's grid (or `schedule`, a
    (cluster, chunk) of it)."""
    if heads.device.type == "cpu":
        b, m, r, _ = heads.shape
        noise = (None if deterministic
                 else per_image_gumbel(seed, (b, r, m), heads.device))
        return _pack(posterior_plain(heads, p_r, offsets, p_tr, grid, sig_r,
                                     noise=noise))
    args, (b, m, r, zd) = _cuda_args(heads, p_r, offsets, p_tr, grid)
    cluster, chunk = schedule or k3_schedule(m, r)
    out = torch.empty((b, 2 * zd + 5), dtype=torch.float32,
                      device=heads.device)
    if b:
        _build.launch("tvae_posterior_fwd", *(t.data_ptr() for t in args),
                      out.data_ptr(), b, r, m, zd, float(sig_r),
                      int(deterministic), int(seed) & 0x7FFFFFFF, cluster,
                      chunk, torch.cuda.current_stream(heads.device).cuda_stream)
        posterior_fwd.launches += 1
    return out


posterior_fwd.launches = 0


def posterior_bwd_plain(g, heads, p_r, offsets, p_tr, grid, sig_r: float,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K4 (the hand-derived VJP of
    targetvae_tpu/kernels/posterior.py::_bwd_one on split_heads' planes).
    g (B, 2*zd + 5) is the packed cotangent. Returns the cotangent of the
    raw heads, (B, M, R, D)."""
    attn, theta_mu, theta_logstd, z_mu, z_logstd = split_heads(heads, p_r,
                                                               offsets)
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
    d_q = g_kl * eq * ((q - p_tr.T) + 1.0 + (kl_th + kl_z))
    d_attn = (a * (d_a - (d_a * a).sum(dim=(1, 2), keepdim=True))
              + d_q - eq * d_q.sum(dim=(1, 2), keepdim=True))
    return join_heads(d_attn, *_moment_grads(
        g_thmu, g_thstd, g_zmu, g_zstd, g_kl, eq, a, theta_mu, th_std, z_mu,
        z_std, offs, sig_r))


def posterior_bwd(seed: int, g, heads, p_r, offsets, p_tr, grid,
                  sig_r: float, *, deterministic: bool = False,
                  schedule: Optional[tuple] = None) -> torch.Tensor:
    """The backward of posterior_fwd (K4) at the same seed: the cotangent of
    the raw heads (B, M, R, D), as posterior_bwd_plain. A CPU heads takes
    the plain version (its noise regenerated by per_image_gumbel from the
    seed); a CUDA one launches csrc/posterior.cu, which regenerates the
    forward's Philox bits, on k4_schedule's grid (or `schedule`, a
    (cluster, chunk, sub) of it)."""
    if heads.device.type == "cpu":
        b, m, r, _ = heads.shape
        noise = (None if deterministic
                 else per_image_gumbel(seed, (b, r, m), heads.device))
        return posterior_bwd_plain(g, heads, p_r, offsets, p_tr, grid, sig_r,
                                   noise=noise)
    args, (b, m, r, zd) = _cuda_args(heads, p_r, offsets, p_tr, grid)
    g = g.to(torch.float32).contiguous()
    _build.check_cuda(args[0], g, dtypes=(torch.float32,) * 2)
    _check_shapes((("g", g, (b, 2 * zd + 5)),))
    cluster, chunk, sub = schedule or k4_schedule(m, r, 3 + 2 * zd)
    dheads = torch.empty_like(args[0])
    if b:
        _build.launch("tvae_posterior_bwd", *(t.data_ptr() for t in args),
                      g.data_ptr(), dheads.data_ptr(), b, r, m, zd,
                      float(sig_r), int(deterministic),
                      int(seed) & 0x7FFFFFFF, cluster, chunk, sub,
                      torch.cuda.current_stream(heads.device).cuda_stream)
        posterior_bwd.launches += 1
    return dheads


posterior_bwd.launches = 0


class _Posterior(torch.autograd.Function):
    """K3 forward, K4 backward at the saved seed. A gradient for the raw
    heads only; p_r, offsets, p_tr and the grid are constants."""

    @staticmethod
    def forward(ctx, heads, p_r, offsets, p_tr, grid, sig_r, seed,
                deterministic):
        ctx.save_for_backward(heads)
        ctx.consts = (p_r, offsets, p_tr, grid)
        ctx.cfg = (sig_r, seed, deterministic)
        return posterior_fwd(seed, heads, p_r, offsets, p_tr, grid, sig_r,
                             deterministic=deterministic)

    @staticmethod
    def backward(ctx, g):
        sig_r, seed, deterministic = ctx.cfg
        (heads,) = ctx.saved_tensors
        dheads = posterior_bwd(seed, g, heads, *ctx.consts, sig_r,
                               deterministic=deterministic)
        return (dheads,) + (None,) * 7


def fused_posterior(seed: int, heads, p_r, offsets, p_tr, grid, sig_r: float,
                    *, deterministic: bool = False) -> dict:
    """heads (B, M, R, D) the encoder's raw heads, D = 3 + 2*zd; p_r (R,)
    log p(r); offsets (R,); p_tr (M, R) log p(t, r); grid (M, 2); sig_r the
    conditional prior std; seed an int.

    Returns z_mu_e/z_std_e (B, zd), theta_mu_e/theta_std_e (B,), dx (B, 2),
    kl (B,); differentiable in the heads through K4. The Function keeps
    only references to its inputs and the seed, so the serving path (no
    gradient) pays nothing for it."""
    out = _Posterior.apply(heads, p_r, offsets, p_tr, grid, sig_r, seed,
                           deterministic)
    return _unpack(out, (heads.shape[-1] - 3) // 2)


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


def pack_planes(attn, th, z) -> torch.Tensor:
    """posterior_shard_partials' arguments attn (B, C), th (B, 2, C) and z
    (B, 2, zd, C) as the planes K5/K6 read, (B, 3 + 2 zd, C)."""
    b, c = attn.shape
    return torch.cat([attn[:, None], th, z.reshape(b, -1, c)], dim=1)


def unpack_planes(planes):
    """pack_planes' inverse: attn (B, C), th (B, 2, C), z (B, 2, zd, C)."""
    b, d, c = planes.shape
    return (planes[:, 0], planes[:, 1:3],
            planes[:, 3:].reshape(b, 2, (d - 3) // 2, c))


def shard_schedule(c: int):
    """K5/K6's grid for shards of c cells: (cluster, chunk). An image is a
    cluster of the smallest of 1, 2, 4, 8, 16 CTAs whose chunks hold at
    most SHARD_CELLS cells, else 16; each CTA takes `chunk` cells (a
    multiple of 4), the last CTA what is left. The grid depends on the
    shard's shape alone, so a row of a batch does not depend on the
    batch's size."""
    ceil4 = lambda n: max(4, -(-n // 4) * 4)
    cluster = next((k for k in (1, 2, 4, 8, 16)
                    if ceil4(-(-c // k)) <= SHARD_CELLS), 16)
    return cluster, ceil4(-(-c // cluster))


def _shard_cuda_args(norms, planes, noise, p, gx, gy, offs):
    """The K5/K6 wrappers' checks: float32 on one device, the planes (B, 3 +
    2 zd, C) with unit cell stride (any row and plane strides), noise (B, C)
    likewise, the rest contiguous. Returns the constants made contiguous,
    zd, and whether every row is 16-byte aligned (the kernels' 16-byte
    loads; else they load cell by cell)."""
    b, d, c = planes.shape
    if d < 5 or d % 2 == 0:
        raise ValueError(f"planes: expected (B, 3 + 2 zd, C), got "
                         f"{tuple(planes.shape)}")
    f32 = torch.float32
    consts = tuple(t.contiguous() for t in (norms, p, gx, gy, offs))
    _build.check_cuda(*consts, dtypes=(f32,) * 5)
    for name, t in (("planes", planes), ("noise", noise)):
        if t.device != norms.device or t.dtype != f32 or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected float32 on {norms.device} "
                             f"with unit cell stride")
    _check_shapes((("norms", consts[0], (b, 4)), ("noise", noise, (b, c)),
                   ("p", consts[1], (c,)), ("gx", consts[2], (c,)),
                   ("gy", consts[3], (c,)), ("offs", consts[4], (c,))))
    vec = (c % 4 == 0 and all(s % 4 == 0 for s in (
        planes.stride(0), planes.stride(1), noise.stride(0)))
        and all(t.data_ptr() % 16 == 0 for t in (planes, noise) + consts[1:]))
    return consts, (d - 3) // 2, vec


def posterior_shard_fwd(norms, planes, noise, p, gx, gy, offs,
                        sig_r: float) -> torch.Tensor:
    """K5: the shard's (B, 2*zd + 5) partial sums from the planes (B, 3 +
    2 zd, C) the batch-to-cell exchange leaves, read where they lie. A CPU
    planes takes the plain version; a CUDA one launches csrc/posterior.cu
    on shard_schedule's grid."""
    if planes.device.type == "cpu":
        attn, th, z = unpack_planes(planes)
        return posterior_shard_plain(norms, attn, noise, th, z, p, gx, gy,
                                     offs, sig_r)
    (norms, p, gx, gy, offs), zd, vec = _shard_cuda_args(
        norms, planes, noise, p, gx, gy, offs)
    b, _, c = planes.shape
    cluster, chunk = shard_schedule(c)
    out = torch.empty((b, 2 * zd + 5), dtype=torch.float32,
                      device=planes.device)
    if b:
        _build.launch("tvae_posterior_shard_fwd", norms.data_ptr(),
                      planes.data_ptr(), noise.data_ptr(), p.data_ptr(),
                      gx.data_ptr(), gy.data_ptr(), offs.data_ptr(),
                      out.data_ptr(), b, c, zd, planes.stride(0),
                      planes.stride(1), noise.stride(0), float(sig_r),
                      cluster, chunk, int(vec),
                      torch.cuda.current_stream(planes.device).cuda_stream)
        posterior_shard_fwd.launches += 1
    return out


posterior_shard_fwd.launches = 0


def posterior_shard_bwd(norms, planes, noise, p, gx, gy, offs, sig_r: float,
                        g):
    """K6 on posterior_shard_fwd's inputs and the TOTAL cotangent g (B,
    2*zd + 5): (gplanes, dadq, spart). gplanes (B, 3 + 2 zd, C) holds the
    theta and z planes' cotangents in planes 1 .. 2 + 2 zd; plane 0, the
    logits', is the caller's (d_attn needs the all-reduced spart; zeros on
    the CPU, unwritten on the card). dadq (B, 2, C) holds d_a and d_q,
    spart (B, 2) the local [sum d_a a, sum d_q]. A CPU planes takes the
    plain version; a CUDA one launches csrc/posterior.cu on K5's grid."""
    b, d, c = planes.shape
    if planes.device.type == "cpu":
        attn, th, z = unpack_planes(planes)
        d_a, d_q, d_th, d_z, spart = posterior_shard_bwd_plain(
            norms, attn, noise, th, z, p, gx, gy, offs, sig_r, g)
        gplanes = torch.cat([torch.zeros_like(attn)[:, None], d_th,
                             d_z.reshape(b, -1, c)], dim=1)
        return gplanes, torch.stack([d_a, d_q], dim=1), spart
    (norms, p, gx, gy, offs), zd, vec = _shard_cuda_args(
        norms, planes, noise, p, gx, gy, offs)
    g = g.to(torch.float32).contiguous()
    _build.check_cuda(norms, g, dtypes=(torch.float32,) * 2)
    _check_shapes((("g", g, (b, 2 * zd + 5)),))
    cluster, chunk = shard_schedule(c)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                   device=planes.device)
    gplanes, dadq, spart = e(b, d, c), e(b, 2, c), e(b, 2)
    if b:
        _build.launch("tvae_posterior_shard_bwd", norms.data_ptr(),
                      planes.data_ptr(), noise.data_ptr(), p.data_ptr(),
                      gx.data_ptr(), gy.data_ptr(), offs.data_ptr(),
                      g.data_ptr(), gplanes.data_ptr(), dadq.data_ptr(),
                      spart.data_ptr(), b, c, zd, planes.stride(0),
                      planes.stride(1), noise.stride(0), d * c, c,
                      float(sig_r), cluster, chunk, int(vec),
                      torch.cuda.current_stream(planes.device).cuda_stream)
        posterior_shard_bwd.launches += 1
    return gplanes, dadq, spart


posterior_shard_bwd.launches = 0


def posterior_shard_partials(norms, attn, noise, th, z, p, gx, gy, offs, *,
                             sig_r: float, zd: int, want_grads: bool = False,
                             g=None):
    """The per-shard posterior kernels with the JAX package's contract (no
    autograd: the VJP lives at the collective level,
    parallel/grid_softmax.py::sp_posterior): packs the planes and calls
    K5 or K6.

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
    planes = pack_planes(attn, th, z)
    if not want_grads:
        return posterior_shard_fwd(norms, planes, noise, p, gx, gy, offs,
                                   sig_r)
    gplanes, dadq, spart = posterior_shard_bwd(norms, planes, noise, p, gx,
                                               gy, offs, sig_r, g)
    _, d_th, d_z = unpack_planes(gplanes)
    return dadq[:, 0], dadq[:, 1], d_th, d_z, spart
