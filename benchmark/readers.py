"""What the per-layer metrics' readers (metrics/<name>.py) share: which
device operations are the port's hand-written kernels, which host
operation launched them, and the frozen counts over the window's batches.

A reader that finds nothing to read returns None, and the run leaves its
metric out of the line; a share of a roofline or a peak is never made up.
"""

from __future__ import annotations

import re

from .counts import flops

# the port's kernels (targetvae_tpu_torch/csrc): the decoder's wgmma
# kernels, the encoder chain's, the posterior's and the shared reduction
PORT_KERNEL = re.compile(r"\(anonymous namespace\)::(wg|chain)::"
                         r"|posterior_\w*kernel|sum_partials_kernel")

# the autograd Functions (host ops) under which each wrapper's launches run
FUNCTIONS = {
    "mix_heads_fwd": "_LiftActMixHeads",
    "mix_heads_bwd": "_LiftActMixHeadsBackward",
    "lifted_encoder_fwd": "_LiftedEncoder",
    "lifted_encoder_bwd": "_LiftedEncoderBackward",
    "posterior_fwd": "_Posterior",
    "posterior_bwd": "_PosteriorBackward",
    "pose_decoder_fwd": "_PoseDecoder",
    "pose_decoder_bwd": "_PoseDecoderBackward",
}


def port_kernel(op) -> bool:
    return bool(PORT_KERNEL.search(op.name))


def launched_under(op, names) -> bool:
    return any(n in names for n in op.chain)


def batches(trace):
    """[(batch size, count)] of the window's steps or encoder calls."""
    return sorted(trace.run.batches.items())


def bound_ms(trace, wrappers) -> float:
    """The frozen least time of every launch of `wrappers` in the window,
    ms; None where a wrapper's launches do not match the window's batches
    (the count would not be the work that ran)."""
    n = sum(c for _, c in batches(trace))
    if any(trace.run.launches.get(w, 0) != n for w in wrappers):
        return None
    return sum(c * flops.kernel_bounds(trace.run.model, b)[w][0]
               for b, c in batches(trace) for w in wrappers)


def ran(trace, wrappers) -> list:
    return [w for w in wrappers if trace.run.launches.get(w, 0)]


def roofline(trace, wrappers, select) -> float:
    """100 x the bound of the launched `wrappers` over the device time of
    the operations `select` picks, or None."""
    wrappers = ran(trace, wrappers)
    if not wrappers:
        return None
    ms = trace.seconds(select) * 1e3
    bound = bound_ms(trace, wrappers)
    if bound is None or ms <= 0:
        return None
    return 100.0 * bound / ms


def idle_share(trace) -> float:
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
