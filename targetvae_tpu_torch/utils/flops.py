"""Analytic FLOP counts of a training step, MFU, and the kernels' roofline
on the H100 (mirror of targetvae_tpu/utils/flops.py).

step_flops counts the algorithmic operations of one training step (forward,
backward, Adam) from the ModelConfig alone, so that a timed step gives a
model FLOPs utilization (MFU). The JAX package's conventions:

  * a multiply-add of a matrix product or a convolution counts 2 FLOPs;
  * backward counts x3 for a layer with weights and a differentiable input
    (its input and weight gradients each cost one forward), x2 where the
    input is data (the lift: its weight gradient only);
  * elementwise work (activations, the posterior's softmax, moments and KL,
    the Fourier cosines, the likelihood, Adam) is not counted. The
    decoder's Fourier stage counts its F x H product only, not the
    coordinates' projection onto the frequencies (a contraction over 2).

The CTF term counts what the port runs (losses/likelihoods.py::ctf_apply):
per image, three real 2-D FFTs forward (the decoded mean y, the flipped
kernel, the inverse) and two backward (the transposes of the inverse's and
of y's), all at S x S with S = n + kc - 1. Each real FFT of N = S^2 points
counts 2.5 N log2 N, half the 5 N log2 N of a complex one. With fit_noise
the variance is filtered too, so the count doubles. PyTorch's autograd runs
the second backward transform (rfft2's) as a full complex transform of S x
S, 5 N log2 N by the same rule, so the card does 6/5 of this count there;
the count is the algorithm's, as everywhere here.

Peaks: NVIDIA's published H100 SXM dense rates (data sheet), which assume
the card's full 700 W power limit; a card set lower runs slower under load,
so a share is read beside the card's power limit. The bf16 tier's MFU is
read against PEAK_BF16. On the float32 tier cuBLAS runs the matrix products
in full float32 (the port sets no allow_tf32), at most PEAK_F32, but cuDNN's
convolutions default to TF32 (torch.backends.cudnn.allow_tf32 is True), at
most PEAK_TF32. A float32 step is read against PEAK_TF32, the fastest
arithmetic that tier runs, so that its share stays a share (below 1)
whatever the split between cuDNN's convolutions and cuBLAS's products.

The kernels' roofline (bound, kernel_bounds, r1_bounds): each kernel's
least time on the card, the larger of its bytes (each input read once, each
output written once) over HBM_BPS and its operations over the peak rate of
their type. A kernel's matrix products and step_flops's terms come from the
same helpers (mix_heads_products, decoder_products, lift_products), so that
a kernel's roofline and the step's count read the same work whatever
implements it. kernel_products gives each kernel's products with the part
of them that repeats the forward (K2 and K12 recompute pre2 = h1 W2 rather
than store it), which step_flops does not count again.
"""

from __future__ import annotations

import math
from typing import Optional

from ..models.encoders import attn_dim_for
from .config import ModelConfig

PEAK_BF16 = 989e12     # FLOP/s, bf16 tensor cores, dense
PEAK_TF32 = 495e12     # FLOP/s, TF32 tensor cores, dense
PEAK_F32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BPS = 3.35e12      # bytes/s of device memory


def tier_peak(compute_dtype: Optional[str]) -> float:
    """The peak a step of the compute tier is read against: PEAK_BF16 for
    "bfloat16", PEAK_TF32 for the float32 tier (None or "float32")."""
    return PEAK_BF16 if compute_dtype == "bfloat16" else PEAK_TF32


def lift_products(pos: int, ck: int, rk: int) -> int:
    """The lift's forward: every one of pos output positions contracts ck =
    C k^2 taps into rk = R K channels (the cuDNN conv, or K11's GEMM)."""
    return 2 * pos * ck * rk


def mix_heads_products(rows: int, ki: int, K: int, D: int) -> tuple:
    """(mixing, heads) forward over `rows` rows (positions x rotations in
    mode C; positions in mode B, whose ki = R K folds fc_r into the
    mixing): pre2 = h1 W2 (ki x K) and the heads h2 Wh (K x D). K1 (K11's
    tail) runs mixing + heads; K2 (K12's chain) recomputes pre2, then dW2
    and dh1, dWh and dh2: 3 mixing + 2 heads."""
    return 2 * rows * ki * K, 2 * rows * K * D


def decoder_products(px: int, F: int, H: int, L: int, n_out: int) -> int:
    """One forward of the decoder's MLP over px pixels: F x H, (L - 1)
    H x H, H x n_out. K7 and K9 run it; K8 twice it (the input and weight
    gradients); K10 three times (it recomputes the forward)."""
    return 2 * px * (F * H + (L - 1) * H * H + H * n_out)


def _decoder_in(cfg: ModelConfig) -> int:
    g = cfg.generator
    return g.embedding_dim if g.fourier_expansion else 2


def encoder_flops(cfg: ModelConfig, batch: int) -> dict:
    """Forward+backward matmul FLOPs of the inference network."""
    e = cfg.encoder
    d_heads = 3 + 2 * e.z_dim
    if e.mode == "A":
        n = e.image_dim * e.image_dim * e.in_channels
        h = e.kernels_num
        latent = e.z_dim + 3
        fwd = 2 * batch * (n * h + (e.num_layers - 1) * h * h
                           + h * 2 * latent)
        # first layer input is data: wgrad only (x2); rest x3
        first = 2 * batch * n * h
        return {"encoder_mlp": first * 2 + (fwd - first) * 3}

    pos = batch * attn_dim_for(e) ** 2
    R = e.groupconv if e.mode == "C" else max(e.groupconv, 1)
    K = e.kernels_num
    k = e.kernels_size if e.mode == "C" else e.image_dim
    out = {"lift_conv": 2 * lift_products(pos, e.in_channels * k * k, R * K)}
    if e.mode == "C":
        # mixing and heads per rotation
        mixing, heads = mix_heads_products(pos * R, K, K, d_heads)
    else:
        # mode B: fc_r folded into the mixing ((R K) x K, R = 1 at
        # groupconv 0), the heads once a position
        mixing, heads = mix_heads_products(pos, R * K, K, d_heads)
    out["mixing"] = 3 * mixing
    out["heads"] = 3 * heads
    return out


def decoder_flops(cfg: ModelConfig, batch: int) -> dict:
    """Forward+backward matmul FLOPs of the coordinate-MLP generator."""
    g = cfg.generator
    n = cfg.encoder.image_dim
    fwd = decoder_products(batch * n * n, _decoder_in(cfg), g.hidden_dim,
                           g.num_layers, g.n_out)
    fwd += 2 * batch * g.z_dim * g.hidden_dim     # latent_linear, per image
    # x3: the first layer's input gradient too (the pose gradients flow
    # through the coordinates' features back to theta and dx)
    return {"decoder_mlp": fwd * 3}


def ctf_fft(cfg: ModelConfig, batch: int, ctf_dim: int) -> dict:
    """The per-particle CTF by FFT (the module's docstring): five real 2-D
    FFTs of N = S^2 points an image, 2.5 N log2 N each, S = n + ctf_dim -
    1; doubled with fit_noise."""
    N = (cfg.encoder.image_dim + ctf_dim - 1) ** 2
    total = 5 * 2.5 * N * math.log2(N) * batch
    if cfg.likelihood.fit_noise:
        total *= 2                                  # the variance too
    return {"ctf_fft": total}


def step_flops(cfg: ModelConfig, batch: int,
               ctf_dim: Optional[int] = None) -> dict:
    """FLOPs of one full training step (forward, backward, Adam).

    ctf_dim: the per-particle CTF kernel size when the Gaussian likelihood
    applies CTF correction, else None.

    Returns {"total": float, "breakdown": {component: flops}}.
    """
    parts: dict = {}
    parts.update(encoder_flops(cfg, batch))
    parts.update(decoder_flops(cfg, batch))
    if ctf_dim:
        parts.update(ctf_fft(cfg, batch, ctf_dim))
    return {"total": float(sum(parts.values())),
            "breakdown": {k: float(v) for k, v in parts.items()}}


def mfu(total_flops: float, step_seconds: float, peak: float) -> float:
    """Model FLOPs utilization: achieved FLOP/s over `peak`, the peak of the
    step's arithmetic (tier_peak)."""
    return total_flops / (step_seconds * peak)


def kernel_products(cfg: ModelConfig, batch: int) -> dict:
    """{kernel: (products, recomputed)} for every kernel that runs cfg's
    mode: a launch's matrix-product operations for `batch` images of cfg,
    and the part of them that repeats forward products (K2, K12 and K1/K2
    at R = 1 recompute pre2 = h1 W2 rather than store it; K10 recomputes
    the forward), which step_flops does not count again. The decoder
    kernels at the image's pixels (K9 and K10 decode at any coordinates:
    here as many as the image has); the posterior kernels run no product.
    Over a bf16 train step's launches, the sum of products - recomputed
    and what runs outside the kernels (the lift's cuDNN weight gradient,
    latent_linear) is step_flops's matrix-product total, with K13, the
    conv tier's lift forward, counted apart: lift_conv_products (the
    benchmark's frozen copy of this function has no K13)."""
    e, g = cfg.encoder, cfg.generator
    dec = decoder_products(batch * e.image_dim ** 2, _decoder_in(cfg),
                           g.hidden_dim, g.num_layers, g.n_out)
    out = {"pose_decoder_fwd": (dec, 0), "pose_decoder_bwd": (2 * dec, 0),
           "decoder_mlp_fwd": (dec, 0), "decoder_mlp_bwd": (3 * dec, dec)}
    if e.mode == "A":
        return out
    D, K = 3 + 2 * e.z_dim, e.kernels_num
    pos = batch * attn_dim_for(e) ** 2
    out["posterior_fwd"] = out["posterior_bwd"] = (0, 0)
    if e.mode == "B":
        mix, heads = mix_heads_products(pos, max(e.groupconv, 1) * K, K, D)
        out["mix_heads_r1_fwd"] = (mix + heads, 0)
        out["mix_heads_r1_bwd"] = (3 * mix + 2 * heads, mix)
        return out
    R = e.groupconv
    mix, heads = mix_heads_products(pos * R, K, K, D)
    lift = lift_products(pos, e.in_channels * e.kernels_size ** 2, R * K)
    out["mix_heads_fwd"] = (mix + heads, 0)
    out["mix_heads_bwd"] = (3 * mix + 2 * heads, mix)
    out["lifted_encoder_fwd"] = (lift + mix + heads, 0)
    out["lifted_encoder_bwd"] = (lift + 3 * mix + 2 * heads, mix)
    return out


def bound(nbytes: float, ops: float, peak: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak rate of their type."""
    t_mem, t_ops = nbytes / HBM_BPS, ops / peak
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def lift_conv_shape(cfg: ModelConfig) -> tuple:
    """The conv tier's lift of modes B and C as K13 runs it: (image side,
    channels, filter side, output side, output channels)."""
    e = cfg.encoder
    k = e.kernels_size if e.mode == "C" else e.image_dim
    return (e.image_dim, e.in_channels, k, attn_dim_for(e),
            max(e.groupconv, 1) * e.kernels_num)


def lift_conv_products(cfg: ModelConfig, batch: int) -> int:
    """K13's matrix-product operations for `batch` images of cfg (modes B
    and C): the lift's forward."""
    n, C, k, hp, N = lift_conv_shape(cfg)
    return lift_products(batch * hp * hp, C * k * k, N)


def lift_conv_bound(cfg: ModelConfig, batch: int):
    """K13's least time: `batch` float32 images (n, n, C) read, the bf16
    weight (N, C k^2) read, the bf16 rows (batch H'^2, N) written; the
    lift's products at the bf16 peak."""
    n, C, k, hp, N = lift_conv_shape(cfg)
    return bound(batch * n * n * C * 4 + C * k * k * N * 2
                 + batch * hp * hp * N * 2, lift_conv_products(cfg, batch),
                 PEAK_BF16)


def shard_bounds(batch: int, z_dim: int, shard_cells: int) -> dict:
    """K5's and K6's least time: one shard of `shard_cells` cells of the
    posterior's grid for `batch` images, given the global normalisers
    (batch, 4). In: the attn, noise, theta (2) and z (2 zd) planes and four
    per-cell constants; out: the (batch, 2 zd + 5) partials, or backward
    (with the cotangent in) the same planes' cotangents and the (batch, 2)
    softmax partials; K3's / K4's elementwise math."""
    B, zd, f4 = batch, z_dim, 4
    sp_planes = (4 + 2 * zd) * B * shard_cells * f4
    return {
        "posterior_shard_fwd": bound(sp_planes + 4 * shard_cells * f4
                                     + 4 * B * f4 + B * (2 * zd + 5) * f4,
                                     B * shard_cells * (40 + 16 * zd),
                                     PEAK_F32),
        "posterior_shard_bwd": bound(2 * sp_planes + 4 * shard_cells * f4
                                     + 4 * B * f4 + B * (2 * zd + 5) * f4
                                     + 2 * B * f4,
                                     B * shard_cells * 2 * (40 + 16 * zd),
                                     PEAK_F32)}


def kernel_bounds(cfg: ModelConfig, batch: int, shard_cells: int = 0) -> dict:
    """Each kernel's least time on the H100 for a batch of `batch` images of
    a mode-C cfg (n_pos = batch H'^2 positions): every input read once,
    every output written once; the operations its arithmetic needs (the
    matrix products of kernel_products at the bf16 tensor-core peak; the
    posterior's elementwise float32 math at the f32 peak, about 40 + 16 zd
    operations a cell forward and twice that backward). K5/K6 at a shard
    of `shard_cells` cells for all `batch` images (shard_bounds)."""
    e, g = cfg.encoder, cfg.generator
    B = batch
    R, K, zd, D = e.groupconv, e.kernels_num, e.z_dim, 3 + 2 * e.z_dim
    n, F, H, L = e.image_dim, g.embedding_dim, g.hidden_dim, g.num_layers
    n_pos = B * attn_dim_for(e) ** 2
    cells = n_pos // B * R              # R * M cells an image; n_pos = B * M
    px = B * n * n
    bf, f4 = 2, 4
    w_mix = (K * K + K * D) * bf + (R * K + K + D) * f4
    w_dec = (F * H + (L - 1) * H * H + H * g.n_out) * bf + (L * H + 1) * f4
    planes = (3 + 2 * zd) * B * cells * f4
    tables = 4 * B * n * F * f4
    ck = e.in_channels * e.kernels_size ** 2
    w_lift = ck * R * K * bf + w_mix
    w_mlp = w_dec + 3 * F * f4 + B * H * f4     # + wf, bf and hz
    ops = {k: v[0] for k, v in kernel_products(cfg, batch).items()}
    return {
        # the patch encoder: P read, heads out (serving: no h1 written)
        "lifted_encoder_fwd": bound(n_pos * ck * bf + w_lift
                                    + n_pos * R * D * f4,
                                    ops["lifted_encoder_fwd"], PEAK_BF16),
        # P, h1 and g read; dWc and the small gradients out; dWc's product
        # and K2's chain (h2 recomputed, dW2, dh1, dWh, dh2)
        "lifted_encoder_bwd": bound(n_pos * ck * bf + n_pos * R * K * bf
                                    + n_pos * R * D * f4 + w_mix
                                    + (ck * R * K + K * K + K * D + K + D
                                       + R * K) * f4,
                                    ops["lifted_encoder_bwd"], PEAK_BF16),
        "decoder_mlp_fwd": bound(px * 2 * f4 + w_mlp + px * g.n_out * f4,
                                 ops["decoder_mlp_fwd"], PEAK_BF16),
        # no residuals: the forward is part of the function (3 products a
        # layer: the forward's, the weight gradient, the input gradient)
        "decoder_mlp_bwd": bound(px * 2 * f4 + px * g.n_out * f4 + w_mlp
                                 + px * 2 * f4 + B * H * f4
                                 + (F * H + (L - 1) * H * H + H * g.n_out
                                    + L * H + g.n_out) * f4,
                                 ops["decoder_mlp_bwd"], PEAK_BF16),
        **shard_bounds(B, zd, shard_cells),
        "mix_heads_fwd": bound(n_pos * R * K * bf + w_mix
                               + n_pos * R * D * f4,
                               ops["mix_heads_fwd"], PEAK_BF16),
        "mix_heads_bwd": bound(n_pos * R * K * bf + n_pos * R * D * f4 + w_mix
                               + n_pos * R * K * bf
                               + (K * K + K * D + K + D + R * K) * f4,
                               ops["mix_heads_bwd"], PEAK_BF16),
        "posterior_fwd": bound(planes + B * (2 * zd + 5) * f4,
                               B * cells * (40 + 16 * zd), PEAK_F32),
        "posterior_bwd": bound(2 * planes + B * (2 * zd + 5) * f4,
                               B * cells * 2 * (40 + 16 * zd), PEAK_F32),
        "pose_decoder_fwd": bound(tables + w_dec + B * H * f4
                                  + px * g.n_out * f4,
                                  ops["pose_decoder_fwd"], PEAK_BF16),
        "pose_decoder_bwd": bound(tables + L * px * H * bf + px * g.n_out * f4
                                  + w_dec + 3 * B * F * f4 + B * H * f4
                                  + (F * H + (L - 1) * H * H + H * g.n_out
                                     + L * H + g.n_out) * f4,
                                  ops["pose_decoder_bwd"], PEAK_BF16),
    }


def r1_bounds(n: int, ki: int, K: int, D: int, b: int, m: int,
              zd: int) -> dict:
    """The least time of the R = 1 kernels on the H100, as kernel_bounds
    counts them: K1 reads pre1 (n, ki) bf16 and the weights and writes (n,
    D) f32, mixing and heads (mix_heads_products); K2 reads pre1, g and the
    weights and writes dpre1 (n, ki) bf16 and the weight gradients, 3
    mixing + 2 heads (pre2 recomputed, dW2, dh1; dWh, dh2); K3 / K4 over b
    images of m cells, as kernel_bounds' posterior rows at R = 1."""
    bf, f4 = 2, 4
    w = (ki * K + K * D) * bf + (ki + K + D) * f4
    planes = (3 + 2 * zd) * b * m * f4
    mix, heads = mix_heads_products(n, ki, K, D)
    return {
        "mix_heads_r1_fwd": bound(n * ki * bf + w + n * D * f4,
                                  mix + heads, PEAK_BF16),
        "mix_heads_r1_bwd": bound(n * ki * bf + n * D * f4 + w + n * ki * bf
                                  + (ki * K + K * D + K + D + ki) * f4,
                                  3 * mix + 2 * heads, PEAK_BF16),
        "posterior_fwd": bound(planes + b * (2 * zd + 5) * f4,
                               b * m * (40 + 16 * zd), PEAK_F32),
        "posterior_bwd": bound(2 * planes + b * (2 * zd + 5) * f4,
                               b * m * 2 * (40 + 16 * zd), PEAK_F32)}
