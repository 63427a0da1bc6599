"""Fused lift-activation + mixing + heads: forward (K1) and backward (K2).

Port of targetvae_tpu/kernels/mix_heads.py::fused_lift_act_mix_heads (its
`_fwd` and `_bwd` with lift=True). Per position, with pre1 the raw lift-conv
output and one W2 shared by every rotation r:

    h1_r  = bf16(act(pre1_r + bc_r))
    h2_r  = bf16(act(h1_r @ bf16(W2) + b2))        (f32 accumulation)
    out_r = h2_r @ bf16(Wh) + bh                   (f32 accumulation)

pre1 is (N, R*K) bf16 with r-major channels (index r*K + o), the row order of
positions is free; out is (N, R*D) float32 with D = 3 + 2*z_dim heads per
rotation. The kernels are csrc/mix_heads.cu; the plain versions below round
at the same points (cast to bf16, back to f32, then an f32 matmul).

The backward saves nothing but the inputs: it recomputes h1 and h2 and
returns the bf16 cotangent dpre1 of the lift conv plus dbc, dW2, db2, dWh,
dbh in float32. _LiftActMixHeads joins the two as one autograd Function.

Mode B runs the same function at R = 1 with a rectangular mixing W2 (KI, K),
KI = R_lift K its lifted channels (fc_r folded into conv2, the JAX package's
_mode_b_fast): mix_heads_r1_fwd / mix_heads_r1_bwd launch their own kernels
(csrc/mix_heads_r1.cu: the forward holds W2 up to KI = 256 and streams it
past that, the backward streams KI in two passes), and _MixHeadsR1 joins
them. The plain versions take either shape.
"""

from __future__ import annotations

import torch

from . import _build
from .decoder_pose import ACT_CODES, _act, _dact, _dact_from_h, bf16_round

TILE_POS = 64     # positions of a work item of the chain (wgmma's M)
FWD_TILE_POS = 128  # of a forward item: one 64-row tile a consumer warpgroup


def mix_heads_from_h1(h1, w2, b2, wh, bh, *, R: int, K: int,
                      act_kind: str = "leakyrelu") -> torch.Tensor:
    """Mixing and heads from the bf16-valued h1 (N, R*KI), w2 (KI, K) (KI = K
    but for mode B's rectangular mixing at R = 1), with the kernels'
    rounding points; shared by K1's and K11's plain versions."""
    n = h1.shape[0]
    pre2 = h1.float().reshape(n, R, -1) @ bf16_round(w2.float()) + b2.float()
    h2 = bf16_round(_act(pre2, act_kind))
    out = h2 @ bf16_round(wh.float()) + bh.float()
    return out.reshape(n, -1)


def lift_act_mix_heads_plain(pre1, bc, w2, b2, wh, bh, *, R: int, K: int,
                             act_kind: str = "leakyrelu") -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    h1 = bf16_round(_act(pre1.float() + bc.float(), act_kind))
    return mix_heads_from_h1(h1, w2, b2, wh, bh, R=R, K=K, act_kind=act_kind)


def mix_heads_fwd(pre1, bc, w2, b2, wh, bh, *, R: int, K: int,
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
    if K % 16 or not 16 <= K <= 128 or not 1 <= d <= 16:
        raise ValueError(f"mix_heads kernel needs K % 16 == 0, 16 <= K <= 128"
                         f" and 1 <= D <= 16, got K={K} D={d}")
    if pre1.data_ptr() % 16:
        raise ValueError("mix_heads kernel needs pre1 16-byte aligned")
    bf, f32 = torch.bfloat16, torch.float32
    args = (pre1, bc.to(f32).contiguous(), w2.to(bf).contiguous(),
            b2.to(f32).contiguous(), wh.to(bf).contiguous(),
            bh.to(f32).contiguous())
    _build.check_cuda(*args, dtypes=(bf, f32, bf, f32, bf, f32))
    out = torch.empty((n, R * d), dtype=f32, device=pre1.device)
    if n:
        blocks, chunk = fwd_schedule(n, R, pre1.device)
        _build.launch("tvae_mix_heads_fwd",
                      *(t.data_ptr() for t in args), out.data_ptr(),
                      n, R, K, d, blocks, chunk, ACT_CODES[act_kind],
                      torch.cuda.current_stream(pre1.device).cuda_stream)
        mix_heads_fwd.launches += 1
    return out


mix_heads_fwd.launches = 0


def lift_act_mix_heads_bwd_plain(pre1, bc, w2, b2, wh, g, *, R: int, K: int,
                                 act_kind: str = "leakyrelu"):
    """Plain PyTorch version of the backward, with the kernel's rounding
    points. g (N, R*D) float32. Returns dpre1 (N, R*KI) bf16 and dbc
    (R*KI,), dw2 (KI, K), db2 (K,), dwh (K, D), dbh (D,) float32 (KI = K but
    for mode B's rectangular mixing at R = 1)."""
    h1 = bf16_round(_act(pre1.float() + bc.float(), act_kind))
    return mix_heads_bwd_from_h1(h1, w2, b2, wh, g, R=R, K=K,
                                 act_kind=act_kind)


def mix_heads_bwd_from_h1(h1, w2, b2, wh, g, *, R: int, K: int,
                          act_kind: str = "leakyrelu",
                          dact_from_pre2: bool = False):
    """The chain from the bf16-valued h1 (N, R*K), with the kernels' rounding
    points; shared by K2's and K12's plain versions. act' of the second
    layer comes from the bf16 h2 (K2, as targetvae_tpu/kernels/mix_heads.py
    takes it) or, with dact_from_pre2, from the f32 pre2 (K12, as
    targetvae_tpu/kernels/lifted_encoder.py takes it); the two differ for
    tanh. Returns what lift_act_mix_heads_bwd_plain returns."""
    n = h1.shape[0]
    d = wh.shape[1]
    h1 = h1.float().reshape(n, R, -1)
    w2r = bf16_round(w2.float())
    pre2 = h1 @ w2r + b2.float()
    h2 = bf16_round(_act(pre2, act_kind))
    g3 = g.float().reshape(n, R, d)
    g16 = bf16_round(g3)
    dwh = torch.einsum("nrk,nrd->kd", h2, g16)
    dbh = g3.sum((0, 1))
    dact2 = (_dact(pre2, act_kind) if dact_from_pre2
             else _dact_from_h(h2, act_kind))
    dpre2 = (g16 @ bf16_round(wh.float()).T) * dact2
    dpre2_16 = bf16_round(dpre2)
    dw2 = torch.einsum("nrk,nrj->kj", h1, dpre2_16)
    db2 = dpre2.sum((0, 1))
    dpre1 = (dpre2_16 @ w2r.T) * _dact_from_h(h1, act_kind)
    return (dpre1.reshape(n, -1).to(torch.bfloat16),
            dpre1.sum(0).reshape(-1), dw2, db2, dwh, dbh)


def _chain_sizes(R: int, K: int, d: int):
    """The chain pass's sums in the order csrc/mix_heads.cu writes them:
    dW2, dWh, db2, dbh, dbc."""
    return (K * K, K * d, K, d, R * K)


def chain_schedule(n: int, R: int, sms: int, tile: int = TILE_POS):
    """The persistent grid of the chain kernels (csrc/mix_heads.cu,
    csrc/lifted_encoder.cu): the (tile of `tile` positions, rotation) work
    items in order, rotations inner, cut into `blocks` runs of `chunk`
    items, about one block for each of `sms` SMs. Block b takes items
    [b * chunk, min(total, (b + 1) * chunk)); item i is tile i // R,
    rotation i % R. Every block holds at least one item. The grid depends
    on the shapes and the card alone, so the sums run in one order on every
    call. Returns (blocks, chunk)."""
    total = -(-n // tile) * R
    chunk = -(-total // max(1, min(sms, total)))
    return -(-total // chunk), chunk


def fwd_schedule(n: int, R: int, device):
    """The grid of K1's and K11's forward chain: chain_schedule over
    128-position tiles on the card's SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return chain_schedule(max(n, 1), R, sms, tile=FWD_TILE_POS)


def chain_scratch(n: int, R: int, K: int, d: int, device):
    """K2's chain pass (also K12's first pass): its grid of G blocks of
    `chunk` items (chain_schedule), the length SP of a partial-sum row, the
    (G, SP) partials and the (SP,) sums they are added into."""
    sp = -(-sum(_chain_sizes(R, K, d)) // 64) * 64
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks, chunk = chain_schedule(max(n, 1), R, sms)
    f32 = torch.float32
    return (blocks, chunk, sp,
            torch.empty((blocks, sp), dtype=f32, device=device),
            torch.zeros((sp,), dtype=f32, device=device))


def chain_grads(out, R: int, K: int, d: int):
    """dbc (R*K,), dw2 (K, K), db2 (K,), dwh (K, D), dbh (D,) from the chain
    pass's summed row."""
    sizes = _chain_sizes(R, K, d)
    dw2, dwh, db2, dbh, dbc = out[:sum(sizes)].split(sizes)
    return dbc, dw2.reshape(K, K), db2, dwh.reshape(K, d), dbh


def mix_heads_bwd(pre1, bc, w2, b2, wh, g, *, R: int, K: int,
                  act_kind: str = "leakyrelu"):
    """The backward of mix_heads_fwd (K2), with the outputs of
    lift_act_mix_heads_bwd_plain. A CPU pre1 takes the plain version; a CUDA
    one launches csrc/mix_heads.cu (the chain kernel on its persistent grid,
    then the in-order sum of its per-block partials)."""
    if pre1.device.type == "cpu":
        return lift_act_mix_heads_bwd_plain(pre1, bc, w2, b2, wh, g, R=R, K=K,
                                            act_kind=act_kind)
    n, rk = pre1.shape
    d = wh.shape[1]
    if rk != R * K or tuple(w2.shape) != (K, K) or wh.shape[0] != K:
        raise ValueError(f"shape mismatch: pre1 {tuple(pre1.shape)}, w2 "
                         f"{tuple(w2.shape)}, wh {tuple(wh.shape)}, R={R} K={K}")
    if K not in (16, 32, 64, 128) or d > 16:
        raise ValueError(f"mix_heads backward kernel needs K in (16, 32, 64, "
                         f"128) and D <= 16, got K={K} D={d}")
    bf, f32 = torch.bfloat16, torch.float32
    args = (pre1, bc.to(f32).contiguous(), w2.to(bf).contiguous(),
            b2.to(f32).contiguous(), wh.to(bf).contiguous(),
            g.to(f32).contiguous())
    _build.check_cuda(*args, dtypes=(bf, f32, bf, f32, bf, f32))
    if tuple(args[5].shape) != (n, R * d):
        raise ValueError(f"g: expected {(n, R * d)}, got {tuple(g.shape)}")
    if pre1.data_ptr() % 16 or args[2].data_ptr() % 16:
        raise ValueError("mix_heads backward kernel needs pre1 and w2 "
                         "16-byte aligned")
    blocks, chunk, sp, part, out = chain_scratch(n, R, K, d, pre1.device)
    dpre1 = torch.empty_like(pre1)
    if n:
        _build.launch("tvae_mix_heads_bwd", *(t.data_ptr() for t in args),
                      dpre1.data_ptr(), part.data_ptr(), out.data_ptr(),
                      n, R, K, d, blocks, chunk, sp, ACT_CODES[act_kind],
                      torch.cuda.current_stream(pre1.device).cuda_stream)
        mix_heads_bwd.launches += 1
    return (dpre1, *chain_grads(out, R, K, d))


mix_heads_bwd.launches = 0


class _LiftActMixHeads(torch.autograd.Function):
    """K1 forward, K2 backward; keeps only the inputs."""

    @staticmethod
    def forward(ctx, pre1, bc, w2, b2, wh, bh, R, K, act_kind):
        ctx.save_for_backward(pre1, bc, w2, b2, wh)
        ctx.cfg = (R, K, act_kind)
        return mix_heads_fwd(pre1, bc, w2, b2, wh, bh, R=R, K=K,
                             act_kind=act_kind)

    @staticmethod
    def backward(ctx, g):
        pre1, bc, w2, b2, wh = ctx.saved_tensors
        R, K, act_kind = ctx.cfg
        grads = mix_heads_bwd(pre1, bc, w2, b2, wh, g.contiguous(), R=R, K=K,
                              act_kind=act_kind)
        return (*grads, None, None, None)


def fused_lift_act_mix_heads(pre1, bc, w2, b2, wh, bh, *, R: int, K: int,
                             act_kind: str = "leakyrelu") -> torch.Tensor:
    """mix_heads_fwd, differentiable in pre1, bc and all weights through K2.
    It keeps only references to its inputs, so the serving path (no
    gradient) pays nothing for the Function."""
    return _LiftActMixHeads.apply(pre1, bc, w2, b2, wh, bh, R, K, act_kind)


# ---------------------------------------------------------------------------
# R = 1 with a rectangular mixing (mode B): csrc/mix_heads_r1.cu
# ---------------------------------------------------------------------------
R1_CHUNK = 64     # the lifted channels a stage of the kernels holds


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it that starts on a 16-byte boundary (the kernels read
    bc and W2 in 16-byte pieces)."""
    return t.clone() if t.data_ptr() % 16 else t


def _r1_check(pre1, w2, wh, K: int):
    n, ki = pre1.shape
    d = wh.shape[1]
    if tuple(w2.shape) != (ki, K) or wh.shape[0] != K:
        raise ValueError(f"shape mismatch: pre1 {tuple(pre1.shape)}, w2 "
                         f"{tuple(w2.shape)}, wh {tuple(wh.shape)}, K={K}")
    if K not in (16, 32, 64, 128) or not 1 <= d <= 16 or ki % 8 or not ki:
        raise ValueError(f"the R = 1 mix_heads kernels need K in (16, 32, 64,"
                         f" 128), 1 <= D <= 16 and KI % 8 == 0, got K={K} "
                         f"D={d} KI={ki}")
    if pre1.data_ptr() % 16:
        raise ValueError("the R = 1 mix_heads kernels need pre1 16-byte "
                         "aligned")
    return n, ki, d


R1_TILE = 64           # positions of a tile of K1 at R = 1 with W2 resident
R1_RESIDENT_KI = 256   # K1 at R = 1 keeps W2 resident up to this KI


def r1_fwd_schedule(n: int, ki: int, sms: int):
    """The persistent grid of K1 at R = 1: chain_schedule over tiles of
    R1_TILE positions where W2 is resident (KI <= R1_RESIDENT_KI; three
    consumer warpgroups a block, a tile each in turn), else of FWD_TILE_POS
    (W2 streamed with pre1, the block's two consumer warpgroups on a tile's
    halves). Block b takes tiles [b chunk, min(tiles, (b + 1) chunk)).
    Returns (blocks, chunk)."""
    tile = R1_TILE if ki <= R1_RESIDENT_KI else FWD_TILE_POS
    return chain_schedule(max(n, 1), 1, sms, tile=tile)


def mix_heads_r1_fwd(pre1, bc, w2, b2, wh, bh, *, K: int,
                     act_kind: str = "leakyrelu") -> torch.Tensor:
    """K1 at R = 1 over KI lifted channels: pre1 (N, KI) bf16; bc (KI,); w2
    (KI, K); b2 (K,); wh (K, D); bh (D,). Returns (N, D) float32. A CPU
    pre1 takes the plain version; a CUDA one launches csrc/mix_heads_r1.cu
    on r1_fwd_schedule's grid."""
    if pre1.device.type == "cpu":
        return lift_act_mix_heads_plain(pre1, bc, w2, b2, wh, bh, R=1, K=K,
                                        act_kind=act_kind)
    n, ki, d = _r1_check(pre1, w2, wh, K)
    bf, f32 = torch.bfloat16, torch.float32
    args = (pre1, _aligned(bc.to(f32).contiguous()),
            _aligned(w2.to(bf).contiguous()), b2.to(f32).contiguous(),
            wh.to(bf).contiguous(), bh.to(f32).contiguous())
    _build.check_cuda(*args, dtypes=(bf, f32, bf, f32, bf, f32))
    out = torch.empty((n, d), dtype=f32, device=pre1.device)
    if n:
        sms = torch.cuda.get_device_properties(
            pre1.device).multi_processor_count
        blocks, chunk = r1_fwd_schedule(n, ki, sms)
        _build.launch("tvae_mix_heads_r1_fwd",
                      *(t.data_ptr() for t in args), out.data_ptr(),
                      n, ki, K, d, blocks, chunk, ACT_CODES[act_kind],
                      torch.cuda.current_stream(pre1.device).cuda_stream)
        mix_heads_r1_fwd.launches += 1
    return out


mix_heads_r1_fwd.launches = 0


def r1_channel_schedule(n: int, ki: int, sms: int):
    """The grid of K2's channel pass at R = 1: each block takes one
    64-channel chunk of KI and one run of `per` consecutive 128-position
    tiles; the nc chunks of a run are neighbouring blocks (so that they
    read its rows of bf16(dpre2) from L2 at about the same time), about
    one block for each of `sms` SMs in all. Returns (runs, per)."""
    tiles = -(-max(n, 1) // FWD_TILE_POS)
    nc = -(-ki // R1_CHUNK)
    runs = max(1, min(tiles, round(sms / nc)))
    per = -(-tiles // runs)
    return -(-tiles // per), per


def mix_heads_r1_bwd(pre1, bc, w2, b2, wh, g, *, K: int,
                     act_kind: str = "leakyrelu"):
    """The backward of mix_heads_r1_fwd (K2 at R = 1), with the outputs of
    lift_act_mix_heads_bwd_plain at R = 1: dpre1 (N, KI) bf16, dbc (KI,),
    dw2 (KI, K), db2 (K,), dwh (K, D), dbh (D,). A CPU pre1 takes the plain
    version; a CUDA one launches csrc/mix_heads_r1.cu: the head pass
    (pre2 recomputed, dWh, dbh, db2 and bf16(dpre2) (N, K) into a scratch)
    on fwd_schedule's grid, the channel pass (dpre1, dW2, dbc) on
    r1_channel_schedule's, and the in-order sums of both passes'
    per-block partials."""
    if pre1.device.type == "cpu":
        return lift_act_mix_heads_bwd_plain(pre1, bc, w2, b2, wh, g, R=1,
                                            K=K, act_kind=act_kind)
    n, ki, d = _r1_check(pre1, w2, wh, K)
    bf, f32 = torch.bfloat16, torch.float32
    args = (pre1, _aligned(bc.to(f32).contiguous()),
            _aligned(w2.to(bf).contiguous()), b2.to(f32).contiguous(),
            wh.to(bf).contiguous(), g.to(f32).contiguous())
    _build.check_cuda(*args, dtypes=(bf, f32, bf, f32, bf, f32))
    if tuple(args[5].shape) != (n, d):
        raise ValueError(f"g: expected {(n, d)}, got {tuple(g.shape)}")
    dev = pre1.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ga, chunk = chain_schedule(max(n, 1), 1, sms, tile=FWD_TILE_POS)
    runs, per = r1_channel_schedule(n, ki, sms)
    spa = -(-(K * d + K + d) // 64) * 64
    spb = -(-(ki * K + ki) // 64) * 64
    # a row of partials for each warpgroup of each block
    part_a = torch.empty((2 * ga, spa), dtype=f32, device=dev)
    part_b = torch.empty((2 * runs, spb), dtype=f32, device=dev)
    sums = torch.zeros((spa + spb,), dtype=f32, device=dev)
    dpre2 = torch.empty((n, K), dtype=bf, device=dev)
    dpre1 = torch.empty_like(pre1)
    if n:
        _build.launch("tvae_mix_heads_r1_bwd", *(t.data_ptr() for t in args),
                      dpre1.data_ptr(), dpre2.data_ptr(), part_a.data_ptr(),
                      part_b.data_ptr(), sums.data_ptr(), n, ki, K, d, ga,
                      chunk, spa, runs, per, spb, ACT_CODES[act_kind],
                      torch.cuda.current_stream(dev).cuda_stream)
        mix_heads_r1_bwd.launches += 1
    dwh, db2, dbh = sums[:K * d + K + d].split((K * d, K, d))
    dw2, dbc = sums[spa:spa + ki * K + ki].split((ki * K, ki))
    return dpre1, dbc, dw2.reshape(ki, K), db2, dwh.reshape(K, d), dbh


mix_heads_r1_bwd.launches = 0


class _MixHeadsR1(torch.autograd.Function):
    """K1 at R = 1 forward, K2 at R = 1 backward; keeps only the inputs."""

    @staticmethod
    def forward(ctx, pre1, bc, w2, b2, wh, bh, K, act_kind):
        ctx.save_for_backward(pre1, bc, w2, b2, wh)
        ctx.cfg = (K, act_kind)
        return mix_heads_r1_fwd(pre1, bc, w2, b2, wh, bh, K=K,
                                act_kind=act_kind)

    @staticmethod
    def backward(ctx, g):
        pre1, bc, w2, b2, wh = ctx.saved_tensors
        K, act_kind = ctx.cfg
        grads = mix_heads_r1_bwd(pre1, bc, w2, b2, wh, g.contiguous(), K=K,
                                 act_kind=act_kind)
        return (*grads, None, None)


def fused_mix_heads_r1(pre1, bc, w2, b2, wh, bh, *, K: int,
                       act_kind: str = "leakyrelu") -> torch.Tensor:
    """mix_heads_r1_fwd, differentiable in pre1, bc and all weights through
    mix_heads_r1_bwd (mode B's mixing and heads)."""
    return _MixHeadsR1.apply(pre1, bc, w2, b2, wh, bh, K, act_kind)
