"""Grid-sharded joint posterior, the sequence-parallel (SP) analogue for
TARGET-VAE (mirror of targetvae_tpu/parallel/grid_softmax.py, its
kernel-composed tier: _global_norms and sp_posterior_kernel, with the
batch-to-cell exchange of targetvae_tpu/train/loop.py::_loss_fn_sp; the
log-prior's sharded log-softmax is a shard of the globally normalised
prior, a constant, losses/elbo.py::sp_shard_constants).

The posterior's long axis, the R x H' x W' cells, is split over the ranks of
a process group. Each rank runs the per-shard kernels K5/K6
(kernels/posterior.py::posterior_shard_fwd/bwd) on its cells, on the planes
the batch-to-cell exchange leaves; a cross-rank log-sum-exp (a MAX, then a
SUM all-reduce) normalises the softmaxes and a SUM all-reduce combines the
partial moments. What crosses ranks per reduction is O(B), whatever the
grid's size.

Gradient convention: every rank computes the same replicated outputs and
differentiates its own share of the loss; the losses of all ranks add up
to the one being minimised (the Trainer differentiates its local mean
divided by the number of ranks). So the cotangent of a rank's partials is
the SUM over ranks of the output's cotangents, and every collective here
is a SUM whose transpose is a SUM, as shard_map's psum.

The float32 tier's SP branch is plain PyTorch (the JAX package's
sharded_log_softmax, sharded_gumbel_softmax, sharded_weighted_moments and
_posterior_block, which its make_joint_posterior runs under shard_map):
posterior_block computes the same (B, 2zd+5) outputs as sp_posterior from
the same planes, with MAX and differentiable SUM all-reduces over the
group; it runs no kernel, on the card as on the CPU. Its Gumbel noise is
the caller's shard of one draw for the whole grid, so that a sampled
float32 SP step samples as the unsharded step does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.posterior import (pack_planes, posterior_shard_bwd,
                                 posterior_shard_fwd)
from ..ops.kl import guarded_moments, normal_kl

_EPS = 1e-6


def _global_norms(logits, group) -> torch.Tensor:
    """A list of K (B, C) logits, each a softmax whose cell axis is sharded
    over `group` -> (B, 2K) [gmax_0, g_logsum_0, gmax_1, ...]: each rank's
    log-sum-exp over its shard, a MAX all-reduce of them (a pure
    numerical shift), then a SUM all-reduce of the exponentials under it;
    gmax + g_logsum is the global log-sum-exp, all the kernels read. No
    gradient flows through them; sp_posterior's backward accounts for the
    normalisers."""
    with torch.no_grad():
        lse = torch.stack([torch.logsumexp(x, dim=-1) for x in logits], 1)
        gmax = lse.clone()
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        gsum = torch.exp(lse - gmax)
        dist.all_reduce(gsum, group=group)
        return torch.stack([gmax, torch.log(gsum)], dim=-1).reshape(
            lse.shape[0], -1)


class _SPPosterior(torch.autograd.Function):
    """K5 under the global normalisers, then a SUM all-reduce; backward: a
    SUM all-reduce of the cotangent, K6 (the theta and z planes'
    cotangents written into the planes' gradient), a SUM all-reduce of the
    softmax-VJP sums and the elementwise d_attn into its plane 0: one
    gradient for the planes, no slices."""

    @staticmethod
    def forward(ctx, planes, noise, p, gx, gy, offs, group, sig_r):
        attn = planes[:, 0]
        norms = _global_norms([attn, attn + noise], group)
        part = posterior_shard_fwd(norms, planes, noise, p, gx, gy, offs,
                                   sig_r)
        dist.all_reduce(part, group=group)
        ctx.save_for_backward(planes, noise, p, gx, gy, offs, norms)
        ctx.cfg = (group, sig_r)
        return part

    @staticmethod
    def backward(ctx, g):
        planes, noise, p, gx, gy, offs, norms = ctx.saved_tensors
        group, sig_r = ctx.cfg
        # out = the all-reduced partials is used on every rank: the total
        # cotangent of this rank's partials is the sum of all ranks' g
        g_tot = g.contiguous().clone()
        dist.all_reduce(g_tot, group=group)
        gplanes, dadq, spart = posterior_shard_bwd(
            norms, planes, noise, p, gx, gy, offs, sig_r, g_tot)
        dist.all_reduce(spart, group=group)                       # (B, 2)
        attn = planes[:, 0]
        a = torch.exp(attn + noise - (norms[:, 2:3] + norms[:, 3:4]))
        eq = torch.exp(attn - (norms[:, 0:1] + norms[:, 1:2]))
        # d_attn = a (d_a - S1) + d_q - e^q S2
        torch.addcmul(dadq[:, 1] - eq * spart[:, 1:2], a,
                      dadq[:, 0] - spart[:, 0:1], out=gplanes[:, 0])
        return (gplanes,) + (None,) * 7


def sp_posterior(group, sig_r: float, planes, noise, p, gx, gy,
                 offs) -> torch.Tensor:
    """The grid-sharded posterior on the per-shard kernels, run on every
    rank of `group` with its LOCAL cell shard, on the planes as the
    batch-to-cell exchange leaves them.

    planes (B, 3 + 2 zd, C_local) float32 [attn, theta_mu, theta_logstd,
    z_mu (zd), z_logstd (zd)], any row and plane strides; noise (B,
    C_local) this rank's Gumbel noise (not differentiated); p (C,) the
    globally log-softmaxed log-prior shard; gx, gy, offs (C,) per-cell
    constants. Padded cells carry -1e30 logits.

    Returns (B, 2zd+5) [z_mu_e (zd), z_std_e (zd), th_mu_e, th_std_e, dx0,
    dx1, kl], the same on every rank; differentiable in the planes."""
    return _SPPosterior.apply(planes, noise, p, gx, gy, offs, group,
                              float(sig_r))


def sp_posterior_kernel(group, sig_r: float, zd: int, attn, noise, th, z, p,
                        gx, gy, offs) -> torch.Tensor:
    """sp_posterior with the JAX package's arguments: attn (B, C), th (B, 2,
    C) = [theta_mu, theta_logstd], z (B, 2, zd, C) = [z_mu, z_logstd],
    packed into the planes; differentiable in attn, th and z."""
    if z.shape[2] != zd:
        raise ValueError(f"z carries z_dim {z.shape[2]}, not {zd}")
    return sp_posterior(group, sig_r, pack_planes(attn, th, z), noise, p, gx,
                        gy, offs)


class _AllToAll(torch.autograd.Function):
    """all_to_all_single over the leading axis (one chunk per rank); its
    transpose is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    # contiguous first: empty_like keeps a view's strides, and the
    # collective writes its output as a contiguous buffer
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def batch_to_cells(x: torch.Tensor, group) -> torch.Tensor:
    """The Ulysses exchange: (b_l, ..., cells) rows of this rank's batch
    over all cells -> (T * b_l, ..., cells / T) rows of every rank's batch
    over this rank's cell shard, T the ranks of `group`. Row s * b_l + r of
    the result is source rank s's local row r. Differentiable: the gradient
    goes back by the inverse exchange."""
    t = dist.get_world_size(group)
    b, *mid, cells = x.shape
    if cells % t:
        raise ValueError(f"{cells} cells do not split over {t} ranks")
    return chunks_to_cells(x.reshape(b, *mid, t, cells // t).movedim(-2, 0),
                           group)


def chunks_to_cells(chunks: torch.Tensor, group) -> torch.Tensor:
    """batch_to_cells on its send buffer: (T, b_l, ..., c) chunks, chunk s
    for rank s, -> (T * b_l, ..., c), read in place when contiguous."""
    t, b, *rest = chunks.shape
    return _AllToAll.apply(chunks, group).reshape(t * b, *rest)


class _HeadsToChunks(torch.autograd.Function):
    """The encoder's raw heads of this rank's rows as the exchange's send
    buffer, in one pass: (b, cells, D) heads, cells r-minor, -> (T, b, D,
    c) chunks of c cells, bias (D, R) added (log p(r) to the logit, the
    offsets to theta's mean), the cells past the grid padded with -1e30
    logits and zero moments. Its backward takes the chunks' cotangent back
    to the heads' layout."""

    @staticmethod
    def forward(ctx, heads, bias, t, c):
        b, cells, d = heads.shape
        r = bias.shape[1]
        out = heads.new_empty((t, b, d, c))
        src = heads.transpose(1, 2)                             # (b, d, cells)
        spans = [(s * c, max(0, min(cells, (s + 1) * c) - s * c))
                 for s in range(t)]
        for s, (lo, n) in enumerate(spans):
            if n:
                torch.add(src[:, :, lo:lo + n].unflatten(2, (n // r, r)),
                          bias[:, None], out=out[s, :, :, :n].unflatten(
                              2, (n // r, r)))
            if n < c:
                out[s, :, 1:, n:] = 0.0
                out[s, :, 0, n:] = -1e30
        ctx.spans, ctx.shape = spans, heads.shape
        return out

    @staticmethod
    def backward(ctx, g):
        gh = g.new_empty(ctx.shape)
        dst = gh.transpose(1, 2)
        for s, (lo, n) in enumerate(ctx.spans):
            dst[:, :, lo:lo + n] = g[s, :, :, :n]
        return gh, None, None, None


def heads_to_chunks(heads, bias, t: int, c: int) -> torch.Tensor:
    """_HeadsToChunks: the send buffer of the SP step's exchange; c a
    multiple of R, so that each chunk holds whole positions."""
    if c % bias.shape[1]:
        raise ValueError(f"chunks of {c} cells split positions of "
                         f"{bias.shape[1]} rotations")
    return _HeadsToChunks.apply(heads, bias, t, c)


# ---- the float32 tier: the posterior block in plain PyTorch ----

class _AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce over `group`; under the gradient convention above
    its transpose is the SUM all-reduce of the cotangent (shard_map's
    psum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The differentiable SUM of x over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)


def sharded_log_softmax(logits: torch.Tensor, group) -> torch.Tensor:
    """log_softmax over the last axis, sharded over the ranks of `group`:
    (B, C_local) -> this rank's shard of the globally normalised log
    posterior. The MAX all-reduce of the local maxima is only a shift, so
    no gradient flows through it (the JAX package stops it); the SUM of the
    exponentials under it is differentiable."""
    with torch.no_grad():
        gmax = logits.amax(dim=-1, keepdim=True)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    gsum = all_reduce_sum(torch.exp(logits - gmax).sum(dim=-1, keepdim=True),
                          group)
    return logits - (torch.log(gsum) + gmax)


def sharded_gumbel_softmax(logits: torch.Tensor, noise: torch.Tensor,
                           group) -> torch.Tensor:
    """The Gumbel-softmax sample over the sharded cell axis: softmax(logits
    + noise) under the cross-rank normaliser. noise (B, C_local) is this
    rank's shard of the Gumbel noise (the JAX package draws it per shard
    from a folded key; the SP step passes a shard of one draw for the
    whole grid)."""
    return torch.exp(sharded_log_softmax(logits + noise, group))


def sharded_weighted_moments(weights: torch.Tensor, values: torch.Tensor,
                             group) -> torch.Tensor:
    """E_w[v] over the sharded cell axis: weights (B, C_local), values
    (B, C_local, D) -> (B, D), summed over the ranks."""
    return all_reduce_sum(torch.einsum("bm,bmd->bd", weights, values), group)


def posterior_block(group, sig_r: float, planes, noise, p, gx, gy,
                    offs) -> torch.Tensor:
    """The float32 grid-sharded posterior (the JAX package's
    _posterior_block) with sp_posterior's contract: planes (B, 3 + 2 zd,
    C_local) [attn, theta_mu, theta_logstd, z_mu (zd), z_logstd (zd)] as
    the exchange leaves them, noise (B, C_local) this rank's shard of the
    Gumbel noise, p (C,) the globally log-softmaxed log-prior shard (a
    constant, so its sharded log-softmax is the shard itself), gx, gy,
    offs (C,). Returns (B, 2zd+5) [z_mu_e, z_std_e, th_mu_e, th_std_e, dx0,
    dx1, kl], the same on every rank, differentiable in the planes. The
    KL is the discrete joint KL plus the expected conditional KLs under
    the NaN-guarded moments; the sample's moments cross ranks in one SUM
    all-reduce and the KL in another (the JAX package's psums, gathered).
    Padded cells (-1e30 logits and log-prior, zero moments) carry exactly
    zero mass."""
    zd = (planes.shape[1] - 3) // 2
    attn, th_mu, th_ls = planes[:, 0], planes[:, 1], planes[:, 2]
    z_mu, z_ls = planes[:, 3:3 + zd], planes[:, 3 + zd:]           # (B,zd,C)
    q = sharded_log_softmax(attn, group)
    a = sharded_gumbel_softmax(attn, noise, group)
    z_std = torch.exp(z_ls) + _EPS
    th_std = torch.exp(th_ls) + _EPS
    zg_mu, zg_std = guarded_moments(q[:, None], z_mu, z_std)
    tg_mu, tg_std = guarded_moments(q, th_mu, th_std)
    kl_z = normal_kl(zg_mu, zg_std, 0.0, 1.0).sum(dim=1)
    kl_th = normal_kl(tg_mu, tg_std, offs, sig_r)
    grid = torch.stack([gx, gy]).expand(attn.shape[0], 2, -1)
    values = torch.cat([z_mu, z_std, th_mu[:, None], th_std[:, None], grid],
                       dim=1)                                 # (B, 2zd+4, C)
    moments = sharded_weighted_moments(a, values.transpose(1, 2), group)
    kl = sharded_weighted_moments(torch.exp(q), (q - p + kl_th + kl_z)[
        ..., None], group)
    return torch.cat([moments, kl], dim=1)
