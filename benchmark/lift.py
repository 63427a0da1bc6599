"""K13, the conv tier's lift forward (the port's csrc/lift_conv.cu), for
the metrics lift_roofline.*: the least time of the window's launches over
their device time. A launch at batch b of the model's lift (image side n,
C channels, filter side k, output side H', N = R K output channels) is
bound by the larger of its products, 2 b H'^2 C k^2 N at the bf16 peak, and
its bytes, the float32 images read, the bf16 weight read and the bf16 rows
written (b n^2 C 4 + C k^2 N 2 + b H'^2 N 2) at HBM_BPS.

The launches are the kernel's own (its namespace, "lift"), counted by the
port's launch_counts()["lift_conv_fwd"]; a window whose count is not its
batches' (a program without K13, or one that ran it elsewhere too) reads
nothing."""

from __future__ import annotations

import re

from .counts import flops

KERNEL = re.compile(r"\(anonymous namespace\)::lift::")


def bound_ms(e, batch: int) -> float:
    """The least time of one launch at `batch` images of encoder e, ms."""
    k = e.kernels_size if e.mode == "C" else e.image_dim
    hp, n, C = flops.attn_dim_for(e), e.image_dim, e.in_channels
    N = max(e.groupconv, 1) * e.kernels_num
    ops = 2 * batch * hp * hp * C * k * k * N
    nbytes = (batch * n * n * C * 4 + C * k * k * N * 2
              + batch * hp * hp * N * 2)
    return max(ops / flops.PEAK_BF16, nbytes / flops.HBM_BPS) * 1e3


def roofline(trace, kind: str):
    """100 x the bound of the window's K13 launches over their device time
    in a run of `kind`, or None."""
    run = trace.run
    n = sum(run.batches.values())
    if run.kind != kind or not n or run.launches.get("lift_conv_fwd") != n:
        return None
    ms = trace.seconds(lambda op: KERNEL.search(op.name)) * 1e3
    if ms <= 0:
        return None
    return 100.0 * sum(c * bound_ms(run.model.encoder, b)
                       for b, c in run.batches.items()) / ms
