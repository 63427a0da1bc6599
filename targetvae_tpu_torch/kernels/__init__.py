"""Hand-written Hopper kernels and their plain PyTorch versions.

kernel_tier is the package's one kernel switch: every dispatch site (encoder,
ELBO, generator) asks it, and nothing else decides. The bf16 compute tier runs
the fused kernels; the float32 tier is model code in plain PyTorch.

Inside the kernel tier each wrapper dispatches on the device of its input
only: a CPU tensor takes the plain version, a CUDA tensor launches the kernel
or raises. The backward wrappers are joined to their forwards by
torch.autograd.Functions (one per module), which the model code reaches
whenever autograd wants a gradient. Each wrapper counts its launches in a
plain integer attribute (`launches`), which launch_counts /
reset_launch_counts read and clear.
"""

from __future__ import annotations

import torch

from .decoder_pose import fused_pose_decoder_tables, pose_decoder_bwd
from .mix_heads import mix_heads_bwd, mix_heads_fwd
from .posterior import posterior_bwd, posterior_fwd

WRAPPERS = {"mix_heads_fwd": mix_heads_fwd,
            "mix_heads_bwd": mix_heads_bwd,
            "posterior_fwd": posterior_fwd,
            "posterior_bwd": posterior_bwd,
            "pose_decoder_fwd": fused_pose_decoder_tables,
            "pose_decoder_bwd": pose_decoder_bwd}


def kernel_tier(compute_dtype) -> bool:
    """True when a computation should go through the fused kernels."""
    return compute_dtype == torch.bfloat16


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
