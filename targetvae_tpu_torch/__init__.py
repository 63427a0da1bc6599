"""PyTorch / CUDA port of targetvae_tpu for one NVIDIA Hopper card.

Mirrors the JAX package's module paths and function names. The float32 tier
is plain PyTorch; the bf16 tier runs hand-written CUDA kernels (csrc/) that
replace the Pallas kernels. This package never imports JAX.
"""

from .models.targetvae import TargetVAE
from .utils.config import (EncoderConfig, GeneratorConfig, LikelihoodConfig,
                           ModelConfig)

__all__ = ["TargetVAE", "ModelConfig", "GeneratorConfig", "EncoderConfig",
           "LikelihoodConfig"]
