"""Hand-written Hopper kernels and their plain PyTorch versions.

kernel_tier is the package's one kernel switch: every dispatch site (encoder,
ELBO, generator) asks it, and nothing else decides. The bf16 compute tier runs
the fused kernels; the float32 tier is model code in plain PyTorch.

encoder_tier picks the mode-C encoder inside the kernel tier, read from
TARGETVAE_ENCODER_TIER at call time as the JAX package reads it: "patch" runs
the fused patch encoder (K11/K12, one im2col GEMM inside the kernel), any
other value the default "conv" tier (the lift conv, then K1/K2).

Inside the kernel tier each wrapper dispatches on the device of its input
only: a CPU tensor takes the plain version, a CUDA tensor launches the kernel
or raises. The backward wrappers are joined to their forwards by
torch.autograd.Functions (one per module), which the model code reaches
whenever autograd wants a gradient. Each wrapper counts its launches in a
plain integer attribute (`launches`), which launch_counts /
reset_launch_counts read and clear. Beside them the kernel tier counts each
dispatch at which a kernel did not take the config (a `*_supported` check
said no) and the plain path ran: the keys "fallback.<site>" of
launch_counts, one site each for the encoder, the posterior, the pose
decoder and the decoder, and "lift" where the conv tier's lift ran cuDNN's
bf16 convolution in place of K13.
"""

from __future__ import annotations

import os

import torch

from .decoder_mlp import decoder_mlp_bwd, decoder_mlp_fwd
from .decoder_pose import fused_pose_decoder_tables, pose_decoder_bwd
from .lift_conv import lift_conv_fwd
from .lifted_encoder import lifted_encoder_bwd, lifted_encoder_fwd
from .mix_heads import (mix_heads_bwd, mix_heads_fwd, mix_heads_r1_bwd,
                        mix_heads_r1_fwd)
from .posterior import (posterior_bwd, posterior_fwd, posterior_shard_bwd,
                        posterior_shard_fwd)

WRAPPERS = {"mix_heads_fwd": mix_heads_fwd,
            "mix_heads_bwd": mix_heads_bwd,
            "mix_heads_r1_fwd": mix_heads_r1_fwd,
            "mix_heads_r1_bwd": mix_heads_r1_bwd,
            "posterior_fwd": posterior_fwd,
            "posterior_bwd": posterior_bwd,
            "posterior_shard_fwd": posterior_shard_fwd,
            "posterior_shard_bwd": posterior_shard_bwd,
            "pose_decoder_fwd": fused_pose_decoder_tables,
            "pose_decoder_bwd": pose_decoder_bwd,
            "decoder_mlp_fwd": decoder_mlp_fwd,
            "decoder_mlp_bwd": decoder_mlp_bwd,
            "lifted_encoder_fwd": lifted_encoder_fwd,
            "lifted_encoder_bwd": lifted_encoder_bwd,
            "lift_conv_fwd": lift_conv_fwd}


FALLBACKS = dict.fromkeys(("encoder", "posterior", "pose_decoder",
                           "decoder", "lift"), 0)


def count_fallback(site: str) -> None:
    """One dispatch of the kernel tier at `site` that ran the plain path."""
    FALLBACKS[site] += 1


def kernel_tier(compute_dtype) -> bool:
    """True when a computation should go through the fused kernels."""
    return compute_dtype == torch.bfloat16


def encoder_tier() -> str:
    """The kernel tier's mode-C encoder: "patch" when TARGETVAE_ENCODER_TIER
    is "patch" (read at each call), else "conv"."""
    return ("patch" if os.environ.get("TARGETVAE_ENCODER_TIER") == "patch"
            else "conv")


def needs_grad(*trees) -> bool:
    """Whether autograd will differentiate through any tensor of `trees`
    (tensors, or dicts and lists of them): the direction a dispatch site
    decides from before any launch."""
    if not torch.is_grad_enabled():
        return False
    todo = list(trees)
    while todo:
        t = todo.pop()
        if isinstance(t, dict):
            todo.extend(t.values())
        elif isinstance(t, (list, tuple)):
            todo.extend(t)
        elif torch.is_tensor(t) and t.requires_grad:
            return True
    return False


def launch_counts() -> dict:
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    counts.update((f"fallback.{site}", n) for site, n in FALLBACKS.items())
    return counts


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for site in FALLBACKS:
        FALLBACKS[site] = 0
