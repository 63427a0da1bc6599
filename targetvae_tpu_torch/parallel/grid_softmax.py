"""Grid-sharded joint posterior, the sequence-parallel (SP) analogue for
TARGET-VAE (mirror of targetvae_tpu/parallel/grid_softmax.py, its
kernel-composed tier: sharded_log_softmax, _global_norms and
sp_posterior_kernel, with the batch-to-cell exchange of
targetvae_tpu/train/loop.py::_loss_fn_sp).

The posterior's long axis, the R x H' x W' cells, is split over the ranks of
a process group. Each rank runs the per-shard kernels K5/K6
(kernels/posterior.py::posterior_shard_partials) on its cells; a
cross-rank log-sum-exp (a MAX, then a SUM all-reduce) normalises the
softmaxes and a SUM all-reduce combines the partial moments. What crosses
ranks per reduction is O(B), whatever the grid's size.

Gradient convention: every rank computes the same replicated outputs and
differentiates its own share of the loss; the losses of all ranks add up
to the one being minimised (the Trainer differentiates its local mean
divided by the number of ranks). So the cotangent of a rank's partials is
the SUM over ranks of the output's cotangents, and every collective here
is a SUM whose transpose is a SUM, as shard_map's psum.

The float32 tier's SP branch (make_joint_posterior, sharded_gumbel_softmax,
sharded_weighted_moments, make_sharded_posterior) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.posterior import posterior_shard_bwd, posterior_shard_fwd


def _global_norms(logits: torch.Tensor, group) -> torch.Tensor:
    """(B, 2, K) logits -> (B, 4) [gmax_0, g_logsum_0, gmax_1, g_logsum_1]
    for the K softmaxes (here K = 2: q and the sample) whose cell axis is
    sharded over `group`: a MAX all-reduce of the local maxima, a pure
    numerical shift (exact without a gradient), then a SUM all-reduce of
    the local sums of exp(logits - gmax). No gradient flows through them;
    sp_posterior_kernel's backward accounts for the normalisers."""
    with torch.no_grad():
        gmax = logits.amax(dim=-1)                              # (B, K)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        gsum = torch.exp(logits - gmax[..., None]).sum(dim=-1)
        dist.all_reduce(gsum, group=group)
        return torch.stack([gmax, torch.log(gsum)], dim=-1).reshape(
            logits.shape[0], -1)


def sharded_log_softmax(logits: torch.Tensor, group) -> torch.Tensor:
    """log_softmax over the last axis of (B, cells_local) logits whose
    cells are sharded over `group`: the local shard of the global
    log_softmax. For constants (the SP path's log-prior); it raises for a
    tensor that wants a gradient, which would miss the normaliser's."""
    if logits.requires_grad:
        raise ValueError("sharded_log_softmax takes constants; the posterior's "
                         "differentiable softmaxes are sp_posterior_kernel's")
    n = _global_norms(logits[:, None], group)
    return logits - n[:, 0:1] - n[:, 1:2]


class _SPPosterior(torch.autograd.Function):
    """K5 under the global normalisers, then a SUM all-reduce; backward: a
    SUM all-reduce of the cotangent, K6, a SUM all-reduce of the
    softmax-VJP sums and the elementwise d_attn."""

    @staticmethod
    def forward(ctx, attn, noise, th, z, p, gx, gy, offs, group, sig_r):
        norms = _global_norms(torch.stack([attn, attn + noise], dim=1), group)
        part = posterior_shard_fwd(norms, attn, noise, th, z, p, gx, gy, offs,
                                   sig_r)
        dist.all_reduce(part, group=group)
        ctx.save_for_backward(attn, noise, th, z, p, gx, gy, offs, norms)
        ctx.cfg = (group, sig_r)
        return part

    @staticmethod
    def backward(ctx, g):
        attn, noise, th, z, p, gx, gy, offs, norms = ctx.saved_tensors
        group, sig_r = ctx.cfg
        # out = the all-reduced partials is used on every rank: the total
        # cotangent of this rank's partials is the sum of all ranks' g
        g_tot = g.contiguous().clone()
        dist.all_reduce(g_tot, group=group)
        da, dq, dth, dz, spart = posterior_shard_bwd(
            norms, attn, noise, th, z, p, gx, gy, offs, sig_r, g_tot)
        dist.all_reduce(spart, group=group)                       # (B, 2)
        a = torch.exp(attn + noise - norms[:, 2:3] - norms[:, 3:4])
        eq = torch.exp(attn - norms[:, 0:1] - norms[:, 1:2])
        d_attn = a * (da - spart[:, 0:1]) + dq - eq * spart[:, 1:2]
        return d_attn, None, dth, dz, None, None, None, None, None, None


def sp_posterior_kernel(group, sig_r: float, zd: int, attn, noise, th, z, p,
                        gx, gy, offs) -> torch.Tensor:
    """The grid-sharded posterior on the per-shard kernels, run on every
    rank of `group` with its LOCAL cell shard.

    attn, noise (B, C_local) float32 (noise: this rank's Gumbel noise, not
    differentiated); th (B, 2, C) = [theta_mu, theta_logstd]; z (B, 2, zd, C)
    = [z_mu, z_logstd]; p (C,) the globally log-softmaxed log-prior shard;
    gx, gy, offs (C,) per-cell constants. Padded cells carry -1e30 logits.

    Returns (B, 2zd+5) [z_mu_e (zd), z_std_e (zd), th_mu_e, th_std_e, dx0,
    dx1, kl], the same on every rank; differentiable in attn, th and z."""
    if z.shape[2] != zd:
        raise ValueError(f"z carries z_dim {z.shape[2]}, not {zd}")
    return _SPPosterior.apply(attn, noise, th, z, p, gx, gy, offs, group,
                              float(sig_r))


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
    chunks = x.reshape(b, *mid, t, cells // t).movedim(-2, 0)
    return _AllToAll.apply(chunks, group).reshape(t * b, *mid, cells // t)
