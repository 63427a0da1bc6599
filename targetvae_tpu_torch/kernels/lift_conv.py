"""The conv tier's lift, forward (K13): an implicit-GEMM convolution.

The lift of the conv tier (models/encoders.py::conv_rows) convolves the
images y (B, H, W, C) with the OIHW weight w (N, C, k, k) (the lifted
filter bank, N = R K, r-major) and hands K1 (or K1 at R = 1 in mode B) the
raw bf16 output as (B H' W', N) rows:

    rows[b H'W' + i W' + j, o] =
        bf16( sum_{c, di, dj} bf16(ypad[b, i + di, j + dj, c]) w[o, c, di, dj])

with the sum in float32 (w already bf16). The JAX package leaves this
convolution to XLA (targetvae_tpu/ops/groupconv.py::lifted_conv2d); no
Pallas kernel is replaced. On the card it is csrc/lift_conv.cu (an
implicit GEMM on wgmma: the image rows in shared memory, A built in
registers, the weight slices by TMA); the plain version below is one
float32 F.conv2d on the bf16-rounded operands.

_LiftConv makes it differentiable in the weight: its backward is the
weight gradient autograd ran through the bf16 F.conv2d, cuDNN's bf16
wgrad on the same channels-last operands (torch.ops.aten.convolution_
backward with output_mask (False, True, False)). The images are data.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

TM, TN = 256, 128                # positions and channels of a work item
STAGE = 64 * TN * 2              # bytes of a ring stage of weight columns
STAGING = 2 * 2 * 128 * 128      # the epilogue's staging tiles
SMEM_MAX = 232448                # a block's shared memory on the H100
MAX_STAGES = 8


@dataclass(frozen=True)
class LiftPlan:
    """How K13 lays out one shape: rows, the most padded image rows a
    256-position tile reads; rs, their stride in elements; stages, the
    depth of the weights' ring; nbuf, the image buffers (2 to build the
    next tile's rows beside the products); items, the (tile, channel
    slice) work items; smem, the block's shared memory in bytes (as
    csrc/lift_conv.cu lays it out)."""
    rows: int
    rs: int
    stages: int
    nbuf: int
    items: int
    smem: int


def out_side(n: int, k: int, pad: int) -> int:
    return n + 2 * pad - k + 1


def tile_rows(B: int, H: int, W: int, k: int, pad: int) -> int:
    """The most padded image rows any 256-position tile reads: from its
    first position's first filter row to its last position's last, over
    the images' rows laid end to end (image b's padded row i is b Hp + i)."""
    hp, ho, wo = H + 2 * pad, out_side(H, k, pad), out_side(W, k, pad)
    m = B * ho * wo
    first = np.arange(0, m, TM, dtype=np.int64)
    last = np.minimum(first + TM, m) - 1
    row = lambda p: (p // (ho * wo)) * hp + (p % (ho * wo)) // wo
    return int((row(last) - row(first)).max()) + k


def _smem(C: int, k: int, rows: int, rs: int, stages: int, nbuf: int) -> int:
    kp = k + (k & 1)
    ks = -(-(-(-C * k * kp // 8) * 8) // 16)
    plane = rows * rs
    img = 2 * (-(-C * plane // 64) * 64 + 32 + C * plane)
    return (1024 + stages * STAGE + STAGING + -(-nbuf * img // 16) * 16
            + ks * 32 + (2 * stages + 4) * 8)


def padded_channels(N: int) -> int:
    """N output channels rounded up to a multiple of 8: the rows' TMA store
    writes whole 16-byte rows (lift_conv_fwd pads the weight with zero
    channels and drops the padded ones from the rows)."""
    return -(-N // 8) * 8


@functools.lru_cache(maxsize=64)
def lift_conv_plan(B: int, H: int, W: int, C: int, k: int, pad: int,
                   N: int) -> Optional[LiftPlan]:
    """K13's layout for images (B, H, W, C), a k x k filter, padding pad
    and N output channels, or None where K13 does not take the shape: an
    empty output, or the image rows a tile reads, the staging tiles and a
    ring of two weight stages past a block's shared memory (mode B's
    image-sized lift at EMPIAR-10025's 110 x 110, k = 110, B >= 2; mode B
    on the galaxy's 64 x 64 x 3). Two image buffers where they leave four
    stages or more, one otherwise."""
    ho, wo = out_side(H, k, pad), out_side(W, k, pad)
    if min(B, C, k, ho, wo, N) < 1:
        return None
    rows = tile_rows(B, H, W, k, pad)
    rs = -(-(W + 2 * pad + 2) // 8) * 8
    items = -(-B * ho * wo // TM) * -(-padded_channels(N) // TN)
    for nbuf, least in ((2, 4), (1, 2)):
        fixed = _smem(C, k, rows, rs, 0, nbuf)
        stages = min(MAX_STAGES, (SMEM_MAX - fixed) // (STAGE + 16))
        if stages >= least:
            return LiftPlan(rows, rs, stages, nbuf, items,
                            _smem(C, k, rows, rs, stages, nbuf))
    return None


def lift_conv_supported(y_shape, w_shape, padding: int) -> bool:
    """Whether K13 takes images of y_shape (B, H, W, C) and the OIHW weight
    of w_shape (N, C, k, k) at `padding`, decided from the shapes alone,
    before any launch (lift_conv_plan)."""
    B, H, W, C = y_shape
    N, _, k, _ = w_shape
    return lift_conv_plan(B, H, W, C, k, padding, N) is not None


def weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """The OIHW bf16 weight (N, C, k, k) as K13's (N8, CKP) K-major matrix:
    each filter row padded to an even width (a zero column when k is odd,
    so that a column pair never spans two rows), the columns to a multiple
    of 8 (whole 16-byte rows for the tensor map), zero channels to N8 =
    padded_channels(N)."""
    n, c, k, _ = w.shape
    w = w.to(torch.bfloat16)
    if k % 2:
        w = F.pad(w, (0, 1))
    w = w.reshape(n, -1)
    pad = (0, -w.shape[1] % 8, 0, padded_channels(n) - n)
    return (F.pad(w, pad) if any(pad) else w).contiguous()


def lift_conv_plain(y: torch.Tensor, w: torch.Tensor,
                    padding: int) -> torch.Tensor:
    """Plain PyTorch version of K13, on any device: one float32 F.conv2d
    of the bf16-rounded images and weight, its sums rounded to bf16 as
    (B H' W', N) rows. (On the card, with cuDNN's TF32 off, as the tests
    and chip_smoke.py set it.)"""
    x = y.detach().to(torch.bfloat16).float().permute(0, 3, 1, 2)
    out = F.conv2d(x, w.to(torch.bfloat16).float(), padding=padding)
    b, n, ho, wo = out.shape
    return out.permute(0, 2, 3, 1).reshape(b * ho * wo, n).to(torch.bfloat16)


def lift_conv_schedule(items: int, device) -> tuple:
    """(blocks, chunk): about one block per SM, each a contiguous chunk of
    items, so that a block walks a tile's channel slices in turn."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunk = -(-items // min(sms, items))
    return -(-items // chunk), chunk


def lift_conv_fwd(y: torch.Tensor, w: torch.Tensor,
                  padding: int) -> torch.Tensor:
    """y (B, H, W, C) images, w (N, C, k, k) the OIHW weight. Returns the
    (B H' W', N) bf16 rows. A CPU y takes the plain version; a CUDA one
    launches csrc/lift_conv.cu, or raises where lift_conv_plan does not
    take the shape."""
    if y.device.type == "cpu":
        return lift_conv_plain(y, w, padding)
    B, H, W, C = y.shape
    N, c_w, k, k2 = w.shape
    if c_w != C or k2 != k:
        raise ValueError(f"shape mismatch: y {tuple(y.shape)}, w "
                         f"{tuple(w.shape)}")
    plan = lift_conv_plan(B, H, W, C, k, padding, N)
    if plan is None:
        raise ValueError(f"K13 does not take y {tuple(y.shape)}, w "
                         f"{tuple(w.shape)}, padding {padding} "
                         f"(lift_conv_supported)")
    f32, bf = torch.float32, torch.bfloat16
    yc = y.detach().to(f32).contiguous()
    wk = weight_matrix(w.detach())
    _build.check_cuda(yc, wk, dtypes=(f32, bf))
    ho, wo = out_side(H, k, padding), out_side(W, k, padding)
    n8 = wk.shape[0]
    out = torch.empty((B * ho * wo, n8), dtype=bf, device=y.device)
    blocks, chunk = lift_conv_schedule(plan.items, y.device)
    _build.launch("tvae_lift_conv_fwd", yc.data_ptr(), wk.data_ptr(),
                  out.data_ptr(), B, H, W, C, k, padding, n8, plan.rows,
                  plan.rs, plan.stages, plan.nbuf, blocks, chunk,
                  torch.cuda.current_stream(y.device).cuda_stream)
    lift_conv_fwd.launches += 1
    return out if n8 == N else out[:, :N].contiguous()


lift_conv_fwd.launches = 0


class _LiftConv(torch.autograd.Function):
    """K13 (or its plain version on the CPU), differentiable in the bf16
    weight through the bf16 convolution's weight gradient."""

    @staticmethod
    def forward(ctx, w, y, padding):
        ctx.save_for_backward(w, y)
        ctx.padding = padding
        return lift_conv_fwd(y, w, padding)

    @staticmethod
    def backward(ctx, g):
        """The bf16 convolution's weight gradient (cuDNN's wgrad on the
        card) on the operands the bf16 F.conv2d's autograd gave it: g as
        the (B, N, H', W') channels-last view of the rows' cotangent, the
        bf16 images and the weight channels-last."""
        w, y = ctx.saved_tensors
        b, h, wd, _ = y.shape
        n, _, k, _ = w.shape
        pad, cl = ctx.padding, torch.channels_last
        g4 = g.contiguous().view(b, out_side(h, k, pad), out_side(wd, k, pad),
                                 n).permute(0, 3, 1, 2)
        x = y.permute(0, 3, 1, 2).to(w.dtype).contiguous(memory_format=cl)
        _, gw, _ = torch.ops.aten.convolution_backward(
            g4, x, w.contiguous(memory_format=cl), None, [1, 1], [pad, pad],
            [1, 1], False, [0, 0], 1, [False, True, False])
        return gw, None, None


def lift_conv(w: torch.Tensor, y: torch.Tensor,
              padding: int) -> torch.Tensor:
    """lift_conv_fwd, differentiable in w (bf16) when autograd wants its
    gradient; the images carry none."""
    if torch.is_grad_enabled() and w.requires_grad:
        return _LiftConv.apply(w, y.detach(), padding)
    return lift_conv_fwd(y, w, padding)
