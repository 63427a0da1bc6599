"""The TARGET-VAE ELBO for the three inference modes (mirror of
targetvae_tpu/losses/elbo.py).

Mode A (unimodal x unimodal): one Gaussian over (theta, dx, z), a
reparameterised draw, closed-form KLs. Modes B (attention x unimodal) and C
(attention x attention): a posterior over the H' x W' translations, for mode
C jointly with the R rotations (reference train_mnist.py:187-294); mode B is
the R = 1 case with offsets 0, the translation prior alone and the
conditional theta prior N(0, theta_prior).
The bf16 tier runs the posterior kernel (K3/K4; the JAX kernel branches,
elbo.py:252-278 and :312-338) and the pose-decoder kernel, for an encoder
config the posterior kernels do not take (posterior_kernel_supported) the
bf16 encoder_apply and the posterior's model code, and for a generator the
pose kernel does not take (pose_decoder_supported) generator_apply's bf16
tier; the float32 tier is the plain model code of elbo.py:234-250, :280-310
and :340-381. Mode A's encoder is float32 on both tiers, its decoder the
pose kernel on the bf16 tier. The posterior math is float32 in both. Both
tiers are differentiable end to end: on the bf16 tier through the kernels'
autograd Functions (K2 or K12, K4, K8 backward kernels); the Fourier w and
b get no gradient.

Sampling: with a torch.Generator the posterior sample is Gumbel-perturbed and
theta and z are reparameterised with normal noise, all drawn from it. With
generator=None there is no noise: the sample is the posterior itself and the
reparameterisation noise is zero (deterministic evaluation).

compute_elbo(sp=group) shards the posterior's cells over the ranks of a
process group (modes B and C; the JAX package's compute_elbo(sp=(mesh,
axis)) and the Trainer's kernel SP step): each rank runs the encoder on
its own rows, the raw heads cross to a cell split in one exchange, the
posterior runs on the rank's cells (bf16: the K5/K6 kernels,
parallel/grid_softmax.py::sp_posterior; float32: posterior_block in plain
PyTorch) and each rank decodes its own rows.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import count_fallback, kernel_tier, needs_grad
from ..kernels.decoder_pose import fused_pose_decoder, pose_decoder_supported
from ..kernels.posterior import fused_posterior, posterior_kernel_supported
from ..models.encoders import (attn_dim_for, encoder_apply, encoder_heads,
                               rotation_constants)
from ..models.generator import generator_apply
from ..ops.gumbel import gumbel_noise
from ..ops.coords import attention_grid, transform_coords
from ..ops.kl import guarded_moments, normal_kl
from ..parallel.grid_softmax import (chunks_to_cells, heads_to_chunks,
                                     posterior_block, sp_posterior)
from ..utils.config import ModelConfig
from ..utils.trace import span
from .likelihoods import reconstruction_log_prob

_EPS = 1e-6


def _translation_log_prior(grid: np.ndarray) -> np.ndarray:
    """log p(t) over attention cells: log-softmaxed N(0, 0.1) density
    (reference train_mnist.py:168-171). grid: (M, 2) -> (M,)."""
    std = 0.1
    lp = (-0.5 * np.log(2 * np.pi) - np.log(std)
          - 0.5 * (grid / std) ** 2).sum(axis=1)
    lp = lp - (np.max(lp) + np.log(np.sum(np.exp(lp - np.max(lp)))))
    return lp.astype(np.float32)


# the bf16 step's per-rank cell shard is padded to a multiple of this, as
# the JAX package's SP kernel tiles it, so that the shards match the JAX
# package's; the float32 step's to a multiple of R (whole positions)
SP_CELL_UNIT = 1024


@functools.lru_cache(maxsize=32)
def sp_shard_constants(ecfg, device: torch.device, ranks: int, rank: int,
                       unit: int) -> dict:
    """The grid-sharded posterior's constants for rank `rank` of `ranks`,
    made once for each config and device (outside inference mode, so that
    autograd may use them). The R*M cells, r-minor as the heads' (the JAX
    package's losses/elbo.py::sp_cell_views; mode B: R = 1), padded to a
    multiple of ranks * unit (unit a multiple of R), so that each shard
    holds c = "c_loc" cells; the pads carry a -1e30 log-prior and zero
    constants. "bias" (D, R): log p(r) for the logit, the offsets for
    theta's mean, 0 for the rest, which the exchange adds to the heads
    (mode B: zeros); "p" (c,) the shard of the joint log-prior (globally
    log-softmaxed, posterior_constants' p_tr; mode B the translation prior
    alone), "gx", "gy" the attention grid and "offs" the offsets of its
    cells (mode B: 0); "sig_r" (pi / R; mode B theta_prior); "cells"."""
    const = posterior_constants(ecfg, device)
    R, zd = const["p_r"].numel(), ecfg.z_dim
    cells = const["p_tr"].numel()
    c = -(-cells // (ranks * unit)) * unit
    shard = slice(rank * c, (rank + 1) * c)
    pad = lambda v, value: torch.cat(
        [v, torch.full((ranks * c - cells,), value, device=device)])[shard]
    with torch.inference_mode(False):
        bias = torch.zeros((3 + 2 * zd, R), device=device)
        bias[0], bias[1] = const["p_r"], const["offsets"]
        grid = const["grid"].repeat_interleave(R, dim=0)
        return {"c_loc": c, "cells": cells, "sig_r": const["sig_r"],
                "bias": bias, "p": pad(const["p_tr"].reshape(-1), -1e30),
                "gx": pad(grid[:, 0], 0.0), "gy": pad(grid[:, 1], 0.0),
                "offs": pad(const["offsets"].repeat(cells // R), 0.0)}


def _wmean(v: torch.Tensor, row_weights: Optional[torch.Tensor]
           ) -> torch.Tensor:
    """Batch mean, or the weighted SUM when per-row weights are given (the
    caller owns the normalisation, see reconstruction_log_prob)."""
    return v.mean() if row_weights is None else row_weights @ v


def _normal_noise(generator: Optional[torch.Generator], shape, device):
    if generator is None:
        return torch.zeros(shape, device=device)
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device)


def reconstruct_log_prob(params: dict, cfg: ModelConfig, x_coord: torch.Tensor,
                         y: torch.Tensor, theta: torch.Tensor, dx: torch.Tensor,
                         z: torch.Tensor,
                         compute_dtype: Optional[torch.dtype] = None,
                         row_weights: Optional[torch.Tensor] = None,
                         ctf: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Decode (theta, dx, z) and score y under the configured likelihood,
    with the per-image CTF kernels ctf (B, kc, kc) where given. On the
    kernel tier the pose decoder derives the coordinates from (theta, dx)
    and the standard image grid, so x_coord must be that grid (it is for
    every caller of the model); a generator K7 (or, under autograd, K8) does
    not take (pose_decoder_supported) decodes the transformed coordinates
    with generator_apply. The likelihood then runs on y_hat in float32 on
    both tiers (the CTF by FFT, likelihoods.ctf_apply)."""
    gcfg, ecfg, lcfg = cfg.generator, cfg.encoder, cfg.likelihood
    grad = needs_grad(params["generator"], theta, dx, z)
    with span("tvae.decoder"):
        kernels = kernel_tier(compute_dtype)
        if kernels and pose_decoder_supported(gcfg, grad):
            y_hat = fused_pose_decoder(theta, dx, z, params["generator"],
                                       gcfg, ecfg.image_dim)
        else:
            if kernels:
                count_fallback("pose_decoder")
            x_t = transform_coords(x_coord, dx, theta)
            y_hat = generator_apply(params["generator"], gcfg, x_t,
                                    z if gcfg.z_dim > 0 else None,
                                    compute_dtype=compute_dtype)
    with span("tvae.likelihood"):
        return reconstruction_log_prob(
            y_hat, y, lcfg.kind, fit_noise=lcfg.fit_noise, ctf=ctf, dx=dx,
            mask_radius=lcfg.mask_radius,
            btw_pixels_space=2.0 / (ecfg.image_dim - 1),
            row_weights=row_weights)


@functools.lru_cache(maxsize=32)
def posterior_constants(ecfg, device: torch.device):
    """The posterior's constants for an encoder config of mode B or C on
    `device`, made once (outside inference mode, so that autograd may use
    them): the attention grid (M, 2), log p(r) and the offsets (R,), the
    joint prior log p(t, r) = log_softmax(log p(t) + log p(r)) over the
    cells, (M, R) m-major as the heads' cells, and the conditional prior's
    std sig_r (pi / R). Mode B has one rotation cell: log p(r) and the
    offset 0, log p(t) alone (already normalised) and sig_r theta_prior."""
    ad = attn_dim_for(ecfg)
    grid_np = attention_grid(ad, ecfg.image_dim)
    with torch.inference_mode(False):
        grid = torch.as_tensor(grid_np, device=device)
        p_t = torch.as_tensor(_translation_log_prior(grid_np), device=device)
        if ecfg.mode == "B":
            zero = torch.zeros((1,), device=device)
            return {"grid": grid, "p_r": zero, "offsets": zero,
                    "p_tr": p_t[:, None], "sig_r": float(ecfg.theta_prior)}
        p_r, offsets = rotation_constants(ecfg, device)
        p_tr = torch.log_softmax((p_t[:, None] + p_r).reshape(-1), dim=0)
    return {"grid": grid, "p_r": p_r, "offsets": offsets,
            "p_tr": p_tr.reshape(ad * ad, ecfg.groupconv),
            "sig_r": float(np.pi / ecfg.groupconv)}


def _mode_a_posterior(params: dict, ecfg, y: torch.Tensor,
                      generator: Optional[torch.Generator],
                      row_weights: Optional[torch.Tensor]):
    """Mode A: (theta, dx, z) from one reparameterised draw of the
    encoder's Gaussian, dx scaled by 0.1 (reference train_mnist.py:62-66),
    and the closed-form KL: theta's against N(0, theta_prior), the unit
    normal's over the translations and the content (:82-83)."""
    enc = encoder_apply(params["encoder"], ecfg, y)
    with span("tvae.posterior"):
        z_mu, z_logstd = enc["z_mu"], enc["z_logstd"]
        z_std = torch.exp(z_logstd)
        zfull = z_std * _normal_noise(generator, z_mu.shape, y.device) + z_mu
        sigma = ecfg.theta_prior
        kl_theta = (-z_logstd[:, 0] + np.log(sigma)
                    + (z_std[:, 0] ** 2 + z_mu[:, 0] ** 2) / (2 * sigma ** 2)
                    - 0.5)
        z_kl = (-z_logstd[:, 1:] + 0.5 * z_std[:, 1:] ** 2
                + 0.5 * z_mu[:, 1:] ** 2 - 0.5)
        kl_div = _wmean(kl_theta + z_kl.sum(dim=1), row_weights)
        return zfull[:, 0], zfull[:, 1:3] * 0.1, zfull[:, 3:], kl_div


def compute_elbo(params: dict, cfg: ModelConfig, x_coord: torch.Tensor,
                 y: torch.Tensor, generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 row_weights: Optional[torch.Tensor] = None,
                 ctf: Optional[torch.Tensor] = None, sp=None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns scalar (elbo, log_p_x_g_z, kl_div), batch means.
    x_coord: (N, 2) base pixel coordinates; y: (B, H, W, C) images; ctf:
    optional (B, kc, kc) real-space CTF kernels of the Gaussian likelihood.

    row_weights: optional (B,) weights turning every batch mean into a
    weighted SUM (caller-normalised), as the JAX package's _wmean: the
    Trainer's zero-weight padding of a ragged tail batch.

    sp: None, or the process group over whose ranks the posterior's cells
    are sharded (modes B and C): every rank of the group calls with its own
    rows y (as many on each rank; row_weights and ctf its rows' too) of the
    group's batch, rank s holding rows s * b .. (s + 1) * b - 1 of it, and
    gets its own rows' (elbo, log_p, kl). `generator` is the group's,
    the same on every rank: on the float32 tier the Gumbel noise is drawn
    once for the whole grid and batch, then z's and theta's, as the
    unsharded call on the group's batch draws them, so that the sample is
    the unsharded one; on the bf16 tier each rank draws its cells' noise
    from a seed the generator gives, as the posterior kernels do."""
    if sp is not None:
        return _sp_elbo(params, cfg, x_coord, y, generator, compute_dtype,
                        row_weights, ctf, sp)
    ecfg = cfg.encoder
    b = y.shape[0]
    zd = ecfg.z_dim
    dev = y.device
    if ecfg.mode == "A":
        theta, dx, z, kl_div = _mode_a_posterior(params, ecfg, y, generator,
                                                 row_weights)
        log_p = reconstruct_log_prob(params, cfg, x_coord, y, theta, dx, z,
                                     compute_dtype=compute_dtype,
                                     row_weights=row_weights, ctf=ctf)
        return log_p - kl_div, log_p, kl_div
    R = 1 if ecfg.mode == "B" else ecfg.groupconv
    M = attn_dim_for(ecfg) ** 2
    const = posterior_constants(ecfg, dev)
    grid = const["grid"]
    sig_r = const["sig_r"]

    fused = kernel_tier(compute_dtype) and posterior_kernel_supported(ecfg)
    if fused:
        # the encoder's raw heads go to the posterior kernels as they lie
        # (B, M, R, D); K3 adds log p(r) and the offsets itself, and K4
        # returns their cotangent in the same layout (mode B: R = 1, p(r)
        # and the offset 0)
        with span("tvae.encoder"):
            heads = encoder_heads(params["encoder"], ecfg, y, compute_dtype)
    else:
        if kernel_tier(compute_dtype):
            count_fallback("posterior")
        enc = encoder_apply(params["encoder"], ecfg, y, generator,
                            compute_dtype)
    with span("tvae.posterior"):
        if fused:
            seed = (0 if generator is None else int(torch.randint(
                0, 2 ** 31 - 1, (1,), generator=generator,
                device=generator.device)))
            post = fused_posterior(
                seed, heads.reshape(b, M, R, -1), const["p_r"],
                const["offsets"], const["p_tr"], grid, sig_r,
                deterministic=generator is None)
            z_mu_e, z_std_e = post["z_mu_e"], post["z_std_e"]
            th_mu_e, th_std_e = post["theta_mu_e"], post["theta_std_e"]
            dx = post["dx"]
            kl_div = _wmean(post["kl"], row_weights)
        else:
            if ecfg.mode == "B":
                # one rotation cell: the (B, H', W', 1) layout of mode C
                enc = {k: v.unsqueeze(3) for k, v in enc.items()}
                enc["q"] = torch.log_softmax(enc["attn"].reshape(b, -1),
                                             dim=1).reshape(enc["attn"].shape)
                enc["offsets"] = const["offsets"]
            q = enc["q"]                                          # (B,H',W',R)
            a_s4 = (enc["a_sampled"] if generator is not None
                    else torch.softmax(enc["attn"].reshape(b, -1), dim=1)
                    .reshape(enc["attn"].shape))
            a_s = a_s4.reshape(b, -1)                             # H'W'R cells
            a_locs = a_s4.sum(dim=3).reshape(b, -1)               # (B, M)
            z_mu = enc["z_mu"].reshape(b, -1, zd)
            z_std = torch.exp(enc["z_logstd"]).reshape(b, -1, zd) + _EPS
            z_mu_e = torch.einsum("bmz,bm->bz", z_mu, a_s)
            z_std_e = torch.einsum("bmz,bm->bz", z_std, a_s)
            dx = a_locs @ grid
            th_mu = enc["theta_mu"].reshape(b, -1)
            th_std = torch.exp(enc["theta_logstd"]).reshape(b, -1) + _EPS
            th_mu_e = (th_mu * a_s).sum(dim=1)
            th_std_e = (th_std * a_s).sum(dim=1)

            # joint prior p(t, r) = log_softmax(p_t + p_r) over (H', W', R)
            # cells
            p_tr_flat = const["p_tr"].reshape(-1)
            qf = q.reshape(b, -1)
            val1 = (torch.exp(qf) * (qf - p_tr_flat)).sum(dim=1)
            zq_mu, zq_std = guarded_moments(qf[..., None], z_mu, z_std)
            tq_mu, tq_std = guarded_moments(qf, th_mu, th_std)
            kl_z = normal_kl(zq_mu, zq_std, 0.0, 1.0).sum(dim=-1)
            offs_cells = enc["offsets"].repeat(M)                 # r-minor
            kl_th = normal_kl(tq_mu, tq_std, offs_cells, sig_r)
            val2 = (torch.exp(qf) * (kl_th + kl_z)).sum(dim=1)
            kl_div = _wmean(val1 + val2, row_weights)

        z = z_std_e * _normal_noise(generator, (b, zd), dev) + z_mu_e
        theta = th_std_e * _normal_noise(generator, (b,), dev) + th_mu_e
    log_p = reconstruct_log_prob(params, cfg, x_coord, y, theta, dx, z,
                                 compute_dtype=compute_dtype,
                                 row_weights=row_weights, ctf=ctf)
    return log_p - kl_div, log_p, kl_div


def _sp_elbo(params: dict, cfg: ModelConfig, x_coord: torch.Tensor,
             y: torch.Tensor, generator: Optional[torch.Generator],
             compute_dtype: Optional[torch.dtype],
             row_weights: Optional[torch.Tensor],
             ctf: Optional[torch.Tensor], group):
    """compute_elbo(sp=group): this rank's rows' (elbo, log_p, kl) with the
    posterior's cells sharded over `group` (the JAX package's
    train/loop.py::_loss_fn_sp and compute_elbo's SP branch)."""
    ecfg = cfg.encoder
    if ecfg.mode == "A":
        raise NotImplementedError(
            "sp with encoder mode A: the unimodal posterior has no grid to "
            "shard")
    zd = ecfg.z_dim
    t_n, t = dist.get_world_size(group), dist.get_rank(group)
    b_l = y.shape[0]
    b = t_n * b_l
    dev = y.device
    kernels = kernel_tier(compute_dtype)
    R = 1 if ecfg.mode == "B" else ecfg.groupconv
    const = sp_shard_constants(ecfg, dev, t_n, t,
                               SP_CELL_UNIT if kernels else R)
    c = const["c_loc"]
    with span("tvae.encoder"):
        heads = encoder_heads(params["encoder"], ecfg, y, compute_dtype)
    with span("tvae.posterior"):
        # batch-split -> cell-split: the raw heads, log p(r) and the offsets
        # added and the cells padded to t_n * c (-1e30 logits, zero
        # moments; the pads carry exactly zero posterior mass and gradient)
        # in one pass into the send buffer, one exchange of all 3 + 2 zd
        # planes; row s * b_l + r of the result is rank s's row r
        planes = chunks_to_cells(heads_to_chunks(
            heads.reshape(b_l, -1, 3 + 2 * zd), const["bias"], t_n, c), group)
        if generator is None:
            noise = torch.zeros((b, c), device=dev)
        elif kernels:
            # each rank's cells draw apart, from the group's seed and its rank
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=generator,
                                     device=generator.device))
            noise = gumbel_noise(
                (b, c), torch.Generator(device=dev).manual_seed(seed + t),
                dev)
        else:
            # the whole grid's draw (the unsharded encoder's), this rank's
            # cells
            full = gumbel_noise((b, const["cells"]), generator, dev)
            noise = torch.nn.functional.pad(
                full, (0, t_n * c - const["cells"]))[:, t * c:(t + 1) * c]
        out = (sp_posterior if kernels else posterior_block)(
            group, const["sig_r"], planes, noise, const["p"], const["gx"],
            const["gy"], const["offs"])
        z_s = out[:, zd:2 * zd] * _normal_noise(generator, (b, zd), dev) \
            + out[:, :zd]
        theta = out[:, 2 * zd + 1] * _normal_noise(generator, (b,), dev) \
            + out[:, 2 * zd]
    rows = slice(t * b_l, (t + 1) * b_l)
    log_p = reconstruct_log_prob(params, cfg, x_coord, y, theta[rows],
                                 out[rows, 2 * zd + 2:2 * zd + 4], z_s[rows],
                                 compute_dtype=compute_dtype,
                                 row_weights=row_weights, ctf=ctf)
    kl = _wmean(out[rows, 2 * zd + 4], row_weights)
    return log_p - kl, log_p, kl
