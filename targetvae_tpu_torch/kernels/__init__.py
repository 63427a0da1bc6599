"""Hand-written Hopper kernels and their plain PyTorch versions.

kernel_tier is the package's one kernel switch: every dispatch site (encoder,
ELBO, generator) asks it, and nothing else decides. The bf16 compute tier runs
the fused kernels; the float32 tier is model code in plain PyTorch.

Inside the kernel tier each wrapper dispatches on the device of its input
only: a CPU tensor takes the plain version, a CUDA tensor launches the kernel
or raises. Each wrapper counts its launches in a plain integer attribute
(`launches`), which launch_counts / reset_launch_counts read and clear.
"""

from __future__ import annotations

import torch

from .decoder_pose import fused_pose_decoder_tables
from .mix_heads import fused_lift_act_mix_heads
from .posterior import fused_posterior

WRAPPERS = {"mix_heads_fwd": fused_lift_act_mix_heads,
            "posterior_fwd": fused_posterior,
            "pose_decoder_fwd": fused_pose_decoder_tables}


def kernel_tier(compute_dtype) -> bool:
    """True when a computation should go through the fused kernels."""
    return compute_dtype == torch.bfloat16


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
