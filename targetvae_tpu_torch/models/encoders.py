"""The three TARGET-VAE encoders (mirror of targetvae_tpu/models/encoders.py).

Reference src/models.py:229-403. Mode A (t_inf=unimodal, r_inf=unimodal) is
an MLP on the flattened image with a unimodal Gaussian posterior over
(theta, dx, z). Mode B (t_inf=attention, r_inf=unimodal) runs one image-sized
conv (groupconv 0), or a group lift whose rotations a learned fc_r collapses
(groupconv 4/8/16), then the 1x1 mixing conv and the heads at each of the
H' x W' translations. Mode C lifts the image onto the rotation group with a
group conv, and a 1x1x1 mixing conv and three heads (attention logit, theta
mean/logstd, z mean/logstd) run per (position, rotation); a joint posterior
is formed over the R x H' x W' grid. Heads are channels-last, (B, H', W', R)
and (B, H', W', R, zd), as in the JAX package; encoder_heads gives mode B's
the same layout with R = 1.

Two tiers, chosen by kernels.kernel_tier(compute_dtype):
  - bf16, with two mode-C encoders chosen by kernels.encoder_tier() where
    the JAX package chooses (encoders.py::_use_encoder_kernel):
      "conv" (default): the lift conv runs as K13 (kernels/lift_conv.py,
      an implicit GEMM on the card; its weight gradient cuDNN's bf16
      wgrad) and the lift activation, mixing and heads run in the fused
      mix_heads kernel, whose backward kernel returns the conv's bf16
      cotangent;
      "patch" (TARGETVAE_ENCODER_TIER=patch): the fused patch encoder, the
      lift one im2col GEMM inside the kernel (kernels/lifted_encoder.py);
    mode B runs the counterpart of the JAX package's _mode_b_fast: the
    image-sized lift as K13, fc_r folded into conv2 as one
    rectangular (R_lift K, K) mixing, then the mix_heads kernel at R = 1
    (it has no patch route, in either package, and widths K1/K2 at R = 1
    do not take raise); mode A's MLP runs in float32 on both tiers, as in
    the JAX package; where the tier has no mode-C kernel for the config's
    widths in the direction asked (encoder_kernel_supported) the JAX
    package's XLA bf16 recipe in plain PyTorch;
  - float32 (compute_dtype=None): plain PyTorch model code.
encoder_heads returns the raw heads of modes B and C, which the kernel-tier
ELBO hands to the posterior kernels as they lie; encoder_apply splits them
and adds the rotation prior and the offsets.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import (count_fallback, encoder_tier, kernel_tier,
                       needs_grad)
from ..kernels.decoder_pose import _act
from ..kernels.lift_conv import lift_conv, lift_conv_supported, out_side
from ..kernels.lifted_encoder import build_patches, fused_lifted_encoder
from ..kernels.mix_heads import (fused_lift_act_mix_heads,
                                 fused_mix_heads_r1,
                                 lift_act_mix_heads_plain)
from ..ops.groupconv import conv2d, lifted_conv2d, lifted_weight
from ..ops.gumbel import gumbel_softmax
from ..ops.rotate import rotate_filter_bank
from ..utils.config import EncoderConfig
from ..utils.initializers import conv2d_init, groupconv_init, linear_init
from ..utils.trace import span


def _check_groupconv(cfg: EncoderConfig) -> None:
    """The JAX package's errors for a groupconv the mode does not take
    (targetvae_tpu/models/encoders.py::encoder_init)."""
    if cfg.mode == "C" and cfg.groupconv not in (4, 8, 16):
        raise ValueError(
            "attention rotation inference (t_inf=attention, r_inf=attention*) "
            f"requires groupconv in (4, 8, 16), got {cfg.groupconv}")
    if cfg.mode == "B" and cfg.groupconv not in (0, 4, 8, 16):
        raise ValueError(
            f"groupconv must be 0, 4, 8 or 16, got {cfg.groupconv}")


def group_offsets(R: int) -> np.ndarray:
    """Group rotation offsets for P4/P8/P16, wrapped to (-pi, pi] with +pi kept
    (reference src/models.py:362-366)."""
    ang = 2.0 * np.pi * np.arange(R) / R
    ang = np.where(ang > np.pi + 1e-9, ang - 2.0 * np.pi, ang)
    return ang.astype(np.float32)


def rotation_log_prior(cfg: EncoderConfig, R: int) -> np.ndarray:
    """log p(r), shape (R,) (reference src/models.py:368-379)."""
    if cfg.rot_refinement:
        offs = group_offsets(R)
        if cfg.normal_prior_over_r:
            sig = cfg.theta_prior
            return (-0.5 * np.log(2 * np.pi) - np.log(sig)
                    - 0.5 * (offs / sig) ** 2).astype(np.float32)
        return np.full(R, -np.log(4 * np.pi), dtype=np.float32)  # U(-2pi, 2pi)
    return np.full(R, -np.log(R), dtype=np.float32)


def attn_dim_for(cfg: EncoderConfig) -> int:
    """Spatial size of the attention map."""
    n = cfg.image_dim
    if cfg.mode == "C":
        return n + 2 * cfg.padding - cfg.kernels_size + 1
    return n + 2 * (n // 2) - n + 1     # mode B: kernel n, padding n//2


def encoder_init(generator: torch.Generator, cfg: EncoderConfig,
                 device=None) -> dict:
    """The JAX package's parameter tree for the config's mode, drawn from
    `generator` in the order of its keys."""
    _check_groupconv(cfg)
    kn, zd = cfg.kernels_num, cfg.z_dim
    if cfg.mode == "A":
        # the MLP on the flattened image -> 2 (z_dim + 3); the reference
        # passes the encoder kernel number as the hidden width
        n = cfg.image_dim * cfg.image_dim * cfg.in_channels
        widths = [n] + [kn] * cfg.num_layers + [2 * (zd + 3)]
        return {"layers": [linear_init(generator, a, o, device=device)
                           for a, o in zip(widths[:-1], widths[1:])]}
    if cfg.mode == "B":
        n = cfg.image_dim
        p = ({"conv1": conv2d_init(generator, cfg.in_channels, kn, n,
                                   device=device)}
             if cfg.groupconv == 0 else
             {"conv1": groupconv_init(generator, cfg.in_channels, kn, n,
                                      device=device),
              "fc_r": linear_init(generator, cfg.groupconv, 1,
                                  device=device)})
        return {**p,
                "conv2": linear_init(generator, kn, kn, device=device),
                "conv_a": linear_init(generator, kn, 1, device=device),
                "conv_r": linear_init(generator, kn, 2, device=device),
                "conv_z": linear_init(generator, kn, 2 * zd, device=device)}
    return {
        "conv1": groupconv_init(generator, cfg.in_channels, kn,
                                cfg.kernels_size, device=device),
        "conv2": linear_init(generator, kn, kn, device=device),
        "conv_a": linear_init(generator, kn, 1, device=device),
        "conv_r": linear_init(generator, kn, 2, device=device),
        "conv_z": linear_init(generator, kn, 2 * zd, device=device),
    }


def head_weights(params: dict):
    """The three 1x1 heads as one (K, 3 + 2*zd) matmul."""
    wh = torch.cat([params["conv_a"]["w"], params["conv_r"]["w"],
                    params["conv_z"]["w"]], dim=1)
    bh = torch.cat([params["conv_a"]["b"], params["conv_r"]["b"],
                    params["conv_z"]["b"]])
    return wh, bh


def _split_heads(out: torch.Tensor, zd: int):
    """(..., D) -> attn, theta_mu, theta_logstd (...,), z_mu, z_logstd (..., zd)."""
    return (out[..., 0], out[..., 1], out[..., 2], out[..., 3:3 + zd],
            out[..., 3 + zd:])


def lift_rows(params: dict, cfg: EncoderConfig, y: torch.Tensor):
    """The raw bf16 mode-C lift conv (no bias, no activation) as
    (B*H'*W', R*K) rows with r-major channels, the mix_heads kernel's input;
    returns (rows, H'). conv_rows does the work."""
    with span("tvae.lift"):
        w = lifted_weight(params["conv1"]["w"], cfg.groupconv)
        return conv_rows(w, y, cfg.padding)


def conv_rows(w: torch.Tensor, y: torch.Tensor, padding: int):
    """The raw bf16 conv of y (B, H, W, C) with the OIHW weight w (out, C, k,
    k) as (B*H'*W', out) rows; returns (rows, H').

    K13 (kernels/lift_conv.py) computes it wherever lift_conv_supported
    takes the shape: the images are read as they lie, rounded to bf16 and
    zero-padded on load, and the rows written as K1 reads them.
    Differentiable in the conv weight only: autograd runs the conv's weight
    gradient (cuDNN's bf16 wgrad, f32 accumulation, bf16 out, as the JAX
    tier's _lift_wgrad), then the cast and the rotation gather back to the
    f32 parameter. The images are data (detached), so no dgrad is run.

    Where the image rows a tile reads outgrow a block's shared memory (mode
    B's image-sized lift at EMPIAR-10025's 110 x 110 or on the galaxy's
    64 x 64 x 3) the kernel tier counts fallback.lift, and the conv runs as
    one bf16 F.conv2d with channels_last operands (cuDNN on the card), so
    that its (B, R*K, H', W') output is stored as (B, H', W', R*K) and the
    rows are a view of it."""
    w = w.to(torch.bfloat16)
    if lift_conv_supported(tuple(y.shape), tuple(w.shape), padding):
        return lift_conv(w, y, padding), out_side(y.shape[1], w.shape[2],
                                                  padding)
    count_fallback("lift")
    x = y.detach().permute(0, 3, 1, 2).to(torch.bfloat16)
    pre1 = F.conv2d(x.contiguous(memory_format=torch.channels_last),
                    w.contiguous(memory_format=torch.channels_last),
                    padding=padding)
    b, c, hp, wp = pre1.shape
    return pre1.permute(0, 2, 3, 1).reshape(b * hp * wp, c).contiguous(), hp


def _mode_c_kernel_tier(params: dict, cfg: EncoderConfig, y: torch.Tensor):
    """bf16 lift conv, then the fused lift-act + mixing + heads kernel:
    (B*H'*W', R*D) heads."""
    R, K = cfg.groupconv, cfg.kernels_num
    rows, _ = lift_rows(params, cfg, y)
    wh, bh = head_weights(params)
    return fused_lift_act_mix_heads(
        rows, params["conv1"]["b"].repeat(R), params["conv2"]["w"],
        params["conv2"]["b"], wh, bh, R=R, K=K, act_kind=cfg.activation)


def _mode_c_bf16_recipe(params: dict, cfg: EncoderConfig, y: torch.Tensor):
    """The bf16 tier where the encoder kernels do not reach
    (encoder_kernel_supported): the JAX package's XLA bf16 recipe
    (targetvae_tpu/models/encoders.py::_mode_c_xla_matmul without its
    kernel) in plain PyTorch, the same function K1 computes, rounded at its
    points, differentiated by autograd: (B*H'*W', R*D) heads."""
    R, K = cfg.groupconv, cfg.kernels_num
    rows, _ = lift_rows(params, cfg, y)
    wh, bh = head_weights(params)
    return lift_act_mix_heads_plain(
        rows, params["conv1"]["b"].repeat(R), params["conv2"]["w"],
        params["conv2"]["b"], wh, bh, R=R, K=K, act_kind=cfg.activation)


def mode_c_matrices(params: dict, cfg: EncoderConfig):
    """The patch tier's rotated filter matrix Wc (C*k*k, R*K) float32, rows
    channel-major (c*k*k + di*k + dj, build_patches' columns) and columns
    r-major (r*K + o, the tiled bias's order); the tiled bias (R*K,); the
    fused head weights. Wc's gradient reaches conv1.w through the rotation
    gather's autograd."""
    R = cfg.groupconv
    rot = rotate_filter_bank(params["conv1"]["w"], R)   # (R, K, C, 1, k, k)
    wc = rot.permute(2, 3, 4, 5, 0, 1).reshape(-1, R * cfg.kernels_num)
    return (wc, params["conv1"]["b"].repeat(R), *head_weights(params))


def _mode_c_patch_tier(params: dict, cfg: EncoderConfig, y: torch.Tensor):
    """The fused patch encoder (targetvae_tpu/models/encoders.py::
    _mode_c_kernel): im2col patches of the padded images, then K11:
    (B*H'*W', R*D) heads."""
    R, K, pad = cfg.groupconv, cfg.kernels_num, cfg.padding
    hp = attn_dim_for(cfg)
    wc, bc, wh, bh = mode_c_matrices(params, cfg)
    with span("tvae.patches"):
        xp = F.pad(y, (0, 0, pad, pad, pad, pad))
        patches = build_patches(xp, cfg.kernels_size, hp, hp)
    return fused_lifted_encoder(
        patches, wc, bc, params["conv2"]["w"], params["conv2"]["b"], wh, bh,
        R=R, K=K, act_kind=cfg.activation)


def _mode_c_f32(params: dict, cfg: EncoderConfig, y: torch.Tensor):
    kind = cfg.activation
    lift = _act(lifted_conv2d(y, params["conv1"]["w"], params["conv1"]["b"],
                              R=cfg.groupconv, padding=cfg.padding), kind)
    h = _act(lift @ params["conv2"]["w"] + params["conv2"]["b"], kind)
    wh, bh = head_weights(params)
    return h @ wh + bh


def mode_b_matrices(params: dict, cfg: EncoderConfig):
    """Mode B's lift and mixing as the kernel route runs them
    (targetvae_tpu/models/encoders.py::_mode_b_fast): the lift's OIHW conv
    weight (R K, C, k, k) with r-major output channels (the plain conv1 at
    groupconv 0), its bias over them (R K,), and the mixing (R K, K) with
    its bias (K,), fc_r folded into conv2 when groupconv > 0:
    M[(r, k'), k] = fc_w[r] W2[k', k], b' = fc_b sum_k' W2[k', k] + b2.
    The fold is torch ops on the parameters, so autograd carries its
    gradient to fc_r and conv2."""
    if cfg.groupconv == 0:
        return (params["conv1"]["w"], params["conv1"]["b"],
                params["conv2"]["w"], params["conv2"]["b"])
    R, K = cfg.groupconv, cfg.kernels_num
    w2 = params["conv2"]["w"]
    fw, fb = params["fc_r"]["w"][:, 0], params["fc_r"]["b"][0]
    return (lifted_weight(params["conv1"]["w"], R),
            params["conv1"]["b"].repeat(R),
            (fw[:, None, None] * w2).reshape(R * K, K),
            fb * w2.sum(dim=0) + params["conv2"]["b"])


def _mode_b_kernel_tier(params: dict, cfg: EncoderConfig, y: torch.Tensor):
    """The bf16 lift conv, then the mixing and heads at R = 1 over the
    R_lift K lifted channels: K1 at R = 1 (mix_heads_r1_fwd, K2 at R = 1
    under autograd). (B*H'*W', D) heads."""
    with span("tvae.lift"):
        w, bc, mix_w, mix_b = mode_b_matrices(params, cfg)
        rows, _ = conv_rows(w, y, cfg.image_dim // 2)
    wh, bh = head_weights(params)
    return fused_mix_heads_r1(rows, bc, mix_w, mix_b, wh, bh,
                              K=cfg.kernels_num, act_kind=cfg.activation)


def _mode_b_f32(params: dict, cfg: EncoderConfig, y: torch.Tensor):
    """The plain mode-B encoder (targetvae_tpu/models/encoders.py::
    encoder_apply's mode-B model code): (B, H', W', D) heads."""
    kind, pad = cfg.activation, cfg.image_dim // 2
    c1 = params["conv1"]
    if cfg.groupconv == 0:
        x = _act(conv2d(y, c1["w"], c1["b"], padding=pad), kind)
    else:
        lift = _act(lifted_conv2d(y, c1["w"], c1["b"], R=cfg.groupconv,
                                  padding=pad), kind)
        # the learned rotation collapse fc_r: Linear(R, 1)
        x = (torch.einsum("bhwrk,r->bhwk", lift, params["fc_r"]["w"][:, 0])
             + params["fc_r"]["b"])
    h = _act(x @ params["conv2"]["w"] + params["conv2"]["b"], kind)
    wh, bh = head_weights(params)
    return h @ wh + bh


def _mode_a(params: dict, cfg: EncoderConfig, y: torch.Tensor) -> dict:
    """The mode-A MLP (reference src/models.py:229-260), float32 on both
    tiers as in the JAX package; the ResidLinear option adds each hidden
    layer's input: act(W h + b + h). z_mu, z_logstd (B, z_dim + 3)."""
    kind = cfg.activation
    layers = params["layers"]
    h = _act(y.reshape(y.shape[0], -1) @ layers[0]["w"] + layers[0]["b"],
             kind)
    for layer in layers[1:-1]:
        pre = h @ layer["w"] + layer["b"]
        h = _act(pre + h if cfg.resid else pre, kind)
    out = h @ layers[-1]["w"] + layers[-1]["b"]
    latent = cfg.z_dim + 3
    return {"z_mu": out[:, :latent], "z_logstd": out[:, latent:]}


def encoder_kernel_supported(cfg: EncoderConfig, tier: str,
                             grad: bool) -> bool:
    """Whether encoder tier `tier` ("conv" or "patch") has kernels for this
    config: its forward (K1 takes K % 16 == 0 up to 128, K11 K in 16, 32,
    64, 128) and, with `grad`, its backward (K2 and K12: K in 16, 32, 64,
    128), all four at most 16 heads, D = 3 + 2 z_dim (z_dim <= 6). The bf16
    tier runs the plain recipe (_mode_c_bf16_recipe) otherwise; the route
    is chosen from the shapes alone, before any launch. Mode C only: mode
    B's widths are checked by _mode_b_heads."""
    K = cfg.kernels_num
    fwd = (K % 16 == 0 and 16 <= K <= 128) if tier == "conv" else (
        K in (16, 32, 64, 128))
    return (3 + 2 * cfg.z_dim <= 16 and fwd
            and (not grad or K in (16, 32, 64, 128)))


def encoder_heads(params: dict, cfg: EncoderConfig, y: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The raw heads of modes B and C, (B, H', W', R, D) float32 (R = 1 for
    mode B) with D = 3 + 2*z_dim channels [attention logit, theta mean,
    theta log-std, z means, z log-stds], before the rotation prior and the
    offsets. On the kernel tier this is a view of K1's or K11's output as
    they write it, which the posterior kernels read where it lies. Mode B
    with TARGETVAE_ENCODER_TIER=patch raises: neither package has a patch
    route for its image-sized lift."""
    _check_groupconv(cfg)
    if cfg.mode == "A":
        raise ValueError("mode A (unimodal x unimodal) has no attention "
                         "heads; encoder_apply returns its moments")
    if cfg.mode == "B":
        return _mode_b_heads(params, cfg, y, compute_dtype)
    if kernel_tier(compute_dtype):
        tier = encoder_tier()
        if not encoder_kernel_supported(cfg, tier, needs_grad(params, y)):
            count_fallback("encoder")
            out = _mode_c_bf16_recipe(params, cfg, y)
        elif tier == "patch":
            out = _mode_c_patch_tier(params, cfg, y)
        else:
            out = _mode_c_kernel_tier(params, cfg, y)
    elif compute_dtype is None:
        out = _mode_c_f32(params, cfg, y)
    else:
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    hp = attn_dim_for(cfg)
    return out.reshape(y.shape[0], hp, hp, cfg.groupconv, -1)


def _mode_b_heads(params: dict, cfg: EncoderConfig, y: torch.Tensor,
                  compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    if kernel_tier(compute_dtype):
        if encoder_tier() == "patch":
            raise NotImplementedError(
                "TARGETVAE_ENCODER_TIER=patch has no mode-B route: the JAX "
                "package has none either, and K11's im2col patches of the "
                "image-sized lift would take "
                f"{cfg.in_channels * cfg.image_dim ** 2 * 2} bytes a position "
                "(1.3 GB a batch of 100 at 50x50); unset it for mode B")
        d = 3 + 2 * cfg.z_dim
        if cfg.kernels_num not in (16, 32, 64, 128) or d > 16:
            raise ValueError(
                "the bf16 tier runs mode B on K1/K2 at R = 1, which take "
                f"kernels_num in (16, 32, 64, 128) and at most 16 heads "
                f"(z_dim <= 6); got kernels_num={cfg.kernels_num}, "
                f"z_dim={cfg.z_dim}. Use the float32 tier "
                "(compute_dtype=None) for these widths")
        out = _mode_b_kernel_tier(params, cfg, y)
    elif compute_dtype is None:
        out = _mode_b_f32(params, cfg, y)
    else:
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    hp = attn_dim_for(cfg)
    return out.reshape(y.shape[0], hp, hp, 1, -1)


@functools.lru_cache(maxsize=32)
def rotation_constants(cfg: EncoderConfig, device: torch.device):
    """log p(r) and the offsets (zeros without rotation refinement), (R,)
    float32 on `device`, made once for each config and device (outside
    inference mode, so that autograd may use them)."""
    R = cfg.groupconv
    offs = (group_offsets(R) if cfg.rot_refinement
            else np.zeros((R,), np.float32))
    with torch.inference_mode(False):
        return (torch.as_tensor(rotation_log_prior(cfg, R), device=device),
                torch.as_tensor(offs, device=device))


def encoder_apply(params: dict, cfg: EncoderConfig, y: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  compute_dtype: Optional[torch.dtype] = None) -> dict:
    """y: (B, H, W, C) channels-last images. generator: draws the Gumbel
    sample `a_sampled`; None skips sampling (embedding).

    Mode C returns attn (logits incl. log p(r)), q (joint log posterior),
    p_r, offsets, theta_mu (incl. offsets), theta_logstd, z_mu, z_logstd:
    the heads of encoder_heads, split, with the rotation prior and the
    offsets added. Mode B returns attn (B, H', W'), theta_mu, theta_logstd,
    z_mu, z_logstd (B, H', W', zd) and a_sampled, as the JAX package's;
    mode A z_mu and z_logstd (B, z_dim + 3)."""
    with span("tvae.encoder"):
        if cfg.mode == "A":
            _check_groupconv(cfg)
            return _mode_a(params, cfg, y)
        heads = encoder_heads(params, cfg, y, compute_dtype)
        b = y.shape[0]
        if cfg.mode == "B":
            attn, theta_mu, theta_logstd, z_mu, z_logstd = _split_heads(
                heads.squeeze(3), cfg.z_dim)
            out = {"attn": attn, "theta_mu": theta_mu,
                   "theta_logstd": theta_logstd, "z_mu": z_mu,
                   "z_logstd": z_logstd}
            if generator is not None:
                out["a_sampled"] = gumbel_softmax(
                    attn.reshape(b, -1), generator).reshape(attn.shape)
            return out
        attn, theta_mu, theta_logstd, z_mu, z_logstd = _split_heads(
            heads, cfg.z_dim)
        p_r, offsets = rotation_constants(cfg, y.device)
        attn = attn + p_r
        flat = attn.reshape(b, -1)
        q = torch.log_softmax(flat, dim=-1).reshape(attn.shape)
        theta_mu = theta_mu + offsets
        out = {"attn": attn, "q": q, "p_r": p_r, "offsets": offsets,
               "theta_mu": theta_mu, "theta_logstd": theta_logstd,
               "z_mu": z_mu, "z_logstd": z_logstd}
        if generator is not None:
            out["a_sampled"] = gumbel_softmax(flat, generator).reshape(
                attn.shape)
        return out


def _param_dict(sub: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in sub.items()})


class Encoder(nn.Module):
    """The encoder's parameters in encoder_init's layout (mode C: conv1 w
    (K, C, 1, k, k) and b; conv2, conv_a, conv_r, conv_z with w (K, out) and
    b; mode B: conv1 (w (K, C, k, k) at groupconv 0), fc_r at groupconv > 0,
    and the same heads; mode A: the list "layers" of w (n_in, n_out) and b);
    encoder_apply computes with them."""

    def __init__(self, cfg: EncoderConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for name, sub in params.items():
            self.add_module(name, nn.ModuleList(map(_param_dict, sub))
                            if isinstance(sub, (list, tuple))
                            else _param_dict(sub))

    def params(self) -> dict:
        return {name: ([dict(d.items()) for d in sub]
                       if isinstance(sub, nn.ModuleList)
                       else dict(sub.items()))
                for name, sub in self.named_children()}
