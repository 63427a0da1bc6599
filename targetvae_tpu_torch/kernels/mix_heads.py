"""Fused lift-activation + mixing + heads, forward (K1).

Port of targetvae_tpu/kernels/mix_heads.py::fused_lift_act_mix_heads (its
`_fwd` with lift=True). Per position, with pre1 the raw lift-conv output and
one W2 shared by every rotation r:

    h1_r  = bf16(act(pre1_r + bc_r))
    h2_r  = bf16(act(h1_r @ bf16(W2) + b2))        (f32 accumulation)
    out_r = h2_r @ bf16(Wh) + bh                   (f32 accumulation)

pre1 is (N, R*K) bf16 with r-major channels (index r*K + o), the row order of
positions is free; out is (N, R*D) float32 with D = 3 + 2*z_dim heads per
rotation. The kernel is csrc/mix_heads.cu; the plain version below rounds at
the same points (cast to bf16, back to f32, then an f32 matmul).
"""

from __future__ import annotations

import torch

from . import _build
from .decoder_pose import ACT_CODES, _act, bf16_round


def lift_act_mix_heads_plain(pre1, bc, w2, b2, wh, bh, *, R: int, K: int,
                             act_kind: str = "leakyrelu") -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    n = pre1.shape[0]
    h1 = bf16_round(_act(pre1.float() + bc.float(), act_kind))
    pre2 = h1.reshape(n, R, K) @ bf16_round(w2.float()) + b2.float()
    h2 = bf16_round(_act(pre2, act_kind))
    out = h2 @ bf16_round(wh.float()) + bh.float()
    return out.reshape(n, -1)


def fused_lift_act_mix_heads(pre1, bc, w2, b2, wh, bh, *, R: int, K: int,
                             act_kind: str = "leakyrelu") -> torch.Tensor:
    """pre1 (N, R*K) bf16; bc (R*K,); w2 (K, K); b2 (K,); wh (K, D); bh (D,).
    Returns (N, R*D) float32. A CPU pre1 takes the plain version; a CUDA one
    launches csrc/mix_heads.cu."""
    if pre1.device.type == "cpu":
        return lift_act_mix_heads_plain(pre1, bc, w2, b2, wh, bh, R=R, K=K,
                                        act_kind=act_kind)
    n, rk = pre1.shape
    d = wh.shape[1]
    if rk != R * K or tuple(w2.shape) != (K, K) or wh.shape[0] != K:
        raise ValueError(f"shape mismatch: pre1 {tuple(pre1.shape)}, w2 "
                         f"{tuple(w2.shape)}, wh {tuple(wh.shape)}, R={R} K={K}")
    if K % 16 or K > 256 or d > 16:
        raise ValueError(f"mix_heads kernel needs K % 16 == 0, K <= 256 and "
                         f"D <= 16, got K={K} D={d}")
    if pre1.data_ptr() % 16:
        raise ValueError("mix_heads kernel needs pre1 16-byte aligned")
    bf, f32 = torch.bfloat16, torch.float32
    args = (pre1, bc.to(f32).contiguous(), w2.to(bf).contiguous(),
            b2.to(f32).contiguous(), wh.to(bf).contiguous(),
            bh.to(f32).contiguous())
    _build.check_cuda(*args, dtypes=(bf, f32, bf, f32, bf, f32))
    out = torch.empty((n, R * d), dtype=f32, device=pre1.device)
    if n:
        _build.launch("tvae_mix_heads_fwd",
                      *(t.data_ptr() for t in args), out.data_ptr(),
                      n, R, K, d, ACT_CODES[act_kind],
                      torch.cuda.current_stream(pre1.device).cuda_stream)
        fused_lift_act_mix_heads.launches += 1
    return out


fused_lift_act_mix_heads.launches = 0
