"""Fused patch encoder: forward (K11) and backward (K12).

Port of targetvae_tpu/kernels/lifted_encoder.py::fused_lifted_encoder (its
`_fwd` and `_bwd`), the mode-C encoder tier that TARGETVAE_ENCODER_TIER=patch
selects. The lifting group conv with an image-sized filter bank is one
matrix product of the im2col patch matrix P (N positions, C*k*k columns) by
the rotated filter matrix Wc (C*k*k, R*K, r-major columns), fused with the
activation, mixing and heads. Per position, with one W2 for every rotation:

    pre1 = P @ bf16(Wc) + bc            (f32 accumulation, not rounded)
    h1   = bf16(act(pre1))
    then K1's mixing and heads from h1  (mix_heads.mix_heads_from_h1)

P is built outside the kernel (build_patches), as the JAX package builds it,
and carries no gradient: images are data. The kernels are
csrc/lifted_encoder.cu; the plain versions below round at the same points.

For training the forward also writes the bf16 h1 (N, R*K); the backward
reads it and P, runs K2's chain from h1 (mix_heads_bwd_from_h1) and forms
dWc = P^T bf16(dpre1). _LiftedEncoder joins the two as one autograd
Function; it saves P and h1, never the lift's f32 values.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .decoder_pose import ACT_CODES, _act, bf16_round, wgrad_schedule
from .mix_heads import (chain_grads, chain_scratch, fwd_schedule,
                        mix_heads_bwd_from_h1, mix_heads_from_h1)


def build_patches(xp: torch.Tensor, k: int, hp: int, wp: int) -> torch.Tensor:
    """im2col: xp (B, n2, n2) or (B, n2, n2, C) pre-padded channels-last
    images -> bf16 (B*hp*wp, C*k*k), one row per output position in (b, i, j)
    order, columns c*k*k + di*k + dj (channel-major, as
    targetvae_tpu/kernels/lifted_encoder.py::build_patches and Wc's rows).
    The result carries no gradient. The TPU's row padding to whole tiles is
    not carried: the kernels mask the tail rows.

    The rows are one strided view of the bf16 images (entry (b, i, j, c, di,
    dj) reads xp[b, i + di, j + dj, c]) copied once; F.unfold's CUDA im2col
    runs one kernel per image, ten times slower at the flagship batch."""
    if xp.dim() == 3:
        xp = xp[..., None]
    b, c = xp.shape[0], xp.shape[3]
    x = xp.detach().to(torch.bfloat16).contiguous()
    sb, sh, sw, sc = x.stride()
    windows = x.as_strided((b, hp, wp, c, k, k), (sb, sh, sw, sc, sh, sw))
    return windows.contiguous().view(b * hp * wp, c * k * k)


def _pad_columns(p: torch.Tensor, wc: Optional[torch.Tensor] = None):
    """P's columns (and Wc's rows) zero-padded to a multiple of 8, so that
    P's rows are whole 16-byte units, as a tensor map needs; the
    flagship's 784 needs none."""
    pad = -p.shape[1] % 8
    if pad:
        p = F.pad(p, (0, pad))
        wc = None if wc is None else F.pad(wc, (0, 0, 0, pad))
    return p, wc


def lifted_encoder_plain(p, wc, bc, w2, b2, wh, bh, *, R: int, K: int,
                         act_kind: str = "leakyrelu", save_h1: bool = False):
    """Plain PyTorch version of K11, on any device. Returns (N, R*D)
    float32, with save_h1 also the bf16 h1 (N, R*K)."""
    pre1 = p.float() @ bf16_round(wc.float()) + bc.float()
    h1 = bf16_round(_act(pre1, act_kind))
    out = mix_heads_from_h1(h1, w2, b2, wh, bh, R=R, K=K, act_kind=act_kind)
    return (out, h1.to(torch.bfloat16)) if save_h1 else out


def lifted_encoder_fwd(p, wc, bc, w2, b2, wh, bh, *, R: int, K: int,
                       act_kind: str = "leakyrelu", save_h1: bool = False):
    """p (N, C*k*k) bf16; wc (C*k*k, R*K); bc (R*K,); w2 (K, K); b2 (K,);
    wh (K, D); bh (D,). Returns (N, R*D) float32, with save_h1 (training)
    also h1 (N, R*K) bf16. A CPU p takes the plain version; a CUDA one
    launches csrc/lifted_encoder.cu."""
    if p.device.type == "cpu":
        return lifted_encoder_plain(p, wc, bc, w2, b2, wh, bh, R=R, K=K,
                                    act_kind=act_kind, save_h1=save_h1)
    n, ck = p.shape
    d = wh.shape[1]
    if (tuple(wc.shape) != (ck, R * K) or tuple(w2.shape) != (K, K)
            or wh.shape[0] != K):
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, wc "
                         f"{tuple(wc.shape)}, w2 {tuple(w2.shape)}, wh "
                         f"{tuple(wh.shape)}, R={R} K={K}")
    if K not in (16, 32, 64, 128) or not 1 <= d <= 16:
        raise ValueError(f"lifted encoder kernel needs K in (16, 32, 64, 128)"
                         f" and 1 <= D <= 16, got K={K} D={d}")
    bf, f32 = torch.bfloat16, torch.float32
    pp, wcp = _pad_columns(p.to(bf).contiguous(), wc.to(bf))
    args = (pp, wcp.contiguous(), bc.to(f32).contiguous(),
            w2.to(bf).contiguous(), b2.to(f32).contiguous(),
            wh.to(bf).contiguous(), bh.to(f32).contiguous())
    _build.check_cuda(*args, dtypes=(bf, bf, f32, bf, f32, bf, f32))
    if args[0].data_ptr() % 16 or args[1].data_ptr() % 16:
        raise ValueError("lifted encoder kernel needs p and wc 16-byte "
                         "aligned")
    out = torch.empty((n, R * d), dtype=f32, device=p.device)
    h1 = (torch.empty((n, R * K), dtype=bf, device=p.device) if save_h1
          else None)
    if n:
        blocks, chunk = fwd_schedule(n, R, p.device)
        _build.launch("tvae_lifted_encoder_fwd", *(t.data_ptr() for t in args),
                      out.data_ptr(), None if h1 is None else h1.data_ptr(),
                      n, pp.shape[1], R, K, d, blocks, chunk,
                      ACT_CODES[act_kind],
                      torch.cuda.current_stream(p.device).cuda_stream)
        lifted_encoder_fwd.launches += 1
    return (out, h1) if save_h1 else out


lifted_encoder_fwd.launches = 0


def lifted_encoder_bwd_plain(p, h1, w2, b2, wh, g, *, R: int, K: int,
                             act_kind: str = "leakyrelu"):
    """Plain PyTorch version of K12, with its rounding points (act' of the
    second layer from the f32 pre2, as the TPU kernel takes it). g (N, R*D)
    float32. Returns dwc (C*k*k, R*K), dbc (R*K,), dw2 (K, K), db2 (K,),
    dwh (K, D), dbh (D,), all float32."""
    dpre1, *rest = mix_heads_bwd_from_h1(h1, w2, b2, wh, g, R=R, K=K,
                                         act_kind=act_kind,
                                         dact_from_pre2=True)
    return (p.float().T @ dpre1.float(), *rest)


def lifted_encoder_bwd(p, h1, w2, b2, wh, g, *, R: int, K: int,
                       act_kind: str = "leakyrelu"):
    """The backward of lifted_encoder_fwd (K12), with the outputs of
    lifted_encoder_bwd_plain. A CPU p takes the plain version; a CUDA one
    launches csrc/lifted_encoder.cu (the chain from h1 on wgmma, the
    split-K dWc on the wgmma weight gradient, the in-order sums of their
    partials)."""
    if p.device.type == "cpu":
        return lifted_encoder_bwd_plain(p, h1, w2, b2, wh, g, R=R, K=K,
                                        act_kind=act_kind)
    n, ck = p.shape
    d = wh.shape[1]
    if (tuple(h1.shape) != (n, R * K) or tuple(w2.shape) != (K, K)
            or wh.shape[0] != K or tuple(g.shape) != (n, R * d)):
        raise ValueError(f"shape mismatch: p {tuple(p.shape)}, h1 "
                         f"{tuple(h1.shape)}, w2 {tuple(w2.shape)}, wh "
                         f"{tuple(wh.shape)}, g {tuple(g.shape)}")
    if K not in (16, 32, 64, 128) or d > 16 or (R * K) % 64:
        raise ValueError(f"lifted encoder backward kernel needs K in (16, 32,"
                         f" 64, 128), D <= 16 and R*K % 64 == 0, got K={K} "
                         f"D={d} R={R}")
    bf, f32 = torch.bfloat16, torch.float32
    pp, _ = _pad_columns(p.to(bf).contiguous())
    args = (pp, h1.to(bf).contiguous(), w2.to(bf).contiguous(),
            b2.to(f32).contiguous(), wh.to(bf).contiguous(),
            g.to(f32).contiguous())
    _build.check_cuda(*args, dtypes=(bf, bf, bf, f32, bf, f32))
    if args[1].data_ptr() % 16 or args[2].data_ptr() % 16:
        raise ValueError("lifted encoder backward kernel needs h1 and w2 "
                         "16-byte aligned")
    dev = p.device
    blocks, chunk, sp, part, out = chain_scratch(n, R, K, d, dev)
    mp = -(-pp.shape[1] // 64) * 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    (_, _, splits), _, rows = wgrad_schedule(max(n, 1), mp, R * K, sms)
    dpre1 = torch.empty((n, R * K), dtype=bf, device=dev)
    gpart = torch.empty((splits, mp, R * K), dtype=f32, device=dev)
    dwc = torch.empty((mp, R * K), dtype=f32, device=dev)
    if n:
        _build.launch("tvae_lifted_encoder_bwd", *(t.data_ptr() for t in args),
                      *(t.data_ptr() for t in (dpre1, part, out, gpart, dwc)),
                      n, pp.shape[1], R, K, d, blocks, chunk, sp, splits,
                      rows, ACT_CODES[act_kind],
                      torch.cuda.current_stream(dev).cuda_stream)
        lifted_encoder_bwd.launches += 1
    return (dwc[:ck], *chain_grads(out, R, K, d))


lifted_encoder_bwd.launches = 0


class _LiftedEncoder(torch.autograd.Function):
    """K11 in its save-h1 mode, K12 as its backward. Gradients for Wc, bc and
    the mixing and head weights; none for the patches."""

    @staticmethod
    def forward(ctx, p, wc, bc, w2, b2, wh, bh, R, K, act_kind):
        out, h1 = lifted_encoder_fwd(p, wc, bc, w2, b2, wh, bh, R=R, K=K,
                                     act_kind=act_kind, save_h1=True)
        ctx.save_for_backward(p, h1, w2, b2, wh)
        ctx.cfg = (R, K, act_kind)
        return out

    @staticmethod
    def backward(ctx, g):
        p, h1, w2, b2, wh = ctx.saved_tensors
        R, K, act_kind = ctx.cfg
        grads = lifted_encoder_bwd(p, h1, w2, b2, wh, g.contiguous(), R=R,
                                   K=K, act_kind=act_kind)
        return (None, *grads, None, None, None)


def fused_lifted_encoder(p, wc, bc, w2, b2, wh, bh, *, R: int, K: int,
                         act_kind: str = "leakyrelu") -> torch.Tensor:
    """lifted_encoder_fwd, differentiable in wc, bc and the mixing and head
    weights through K12. Only training pays for the saved h1: without a
    gradient to take, K11 runs alone in its serving mode."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (wc, bc, w2, b2, wh, bh)):
        return _LiftedEncoder.apply(p, wc, bc, w2, b2, wh, bh, R, K, act_kind)
    return lifted_encoder_fwd(p, wc, bc, w2, b2, wh, bh, R=R, K=K,
                              act_kind=act_kind)
