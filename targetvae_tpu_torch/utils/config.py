"""Dataclass configuration layer (mirror of targetvae_tpu/utils/config.py).

The field names, defaults and the JSON format are identical to the JAX
package's, so one config string builds both models.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class GeneratorConfig:
    """SpatialGenerator hyperparameters (reference src/models.py:65-123)."""
    z_dim: int = 2
    hidden_dim: int = 512
    n_out: int = 1
    num_layers: int = 2
    activation: str = "leakyrelu"        # leakyrelu | tanh
    resid: bool = False
    fourier_expansion: bool = False
    fourier_sigma: float = 0.01
    embedding_dim: int = 1024


@dataclass(frozen=True)
class EncoderConfig:
    """Inference-network hyperparameters (reference src/models.py:229-403)."""
    t_inf: str = "attention"             # unimodal | attention
    r_inf: str = "attention+offsets"     # unimodal | attention | attention+offsets
    image_dim: int = 50
    in_channels: int = 1
    z_dim: int = 2
    kernels_num: int = 128
    kernels_size: int = 28               # lifting-conv kernel size (mode C)
    padding: int = 8                     # lifting-conv padding (mode C)
    num_layers: int = 2                  # unimodal-MLP hidden layers (mode A)
    activation: str = "leakyrelu"
    resid: bool = False
    groupconv: int = 8                   # 0 | 4 | 8 | 16
    theta_prior: float = math.pi
    normal_prior_over_r: bool = False

    @property
    def rot_refinement(self) -> bool:
        return self.r_inf == "attention+offsets"

    @property
    def mode(self) -> str:
        """'A' unimodal x unimodal; 'B' attention x unimodal; 'C' attention x attention."""
        if self.t_inf == "unimodal" and self.r_inf == "unimodal":
            return "A"
        if self.t_inf == "attention" and self.r_inf == "unimodal":
            return "B"
        return "C"


@dataclass(frozen=True)
class LikelihoodConfig:
    """Reconstruction likelihood head."""
    kind: str = "bernoulli"              # bernoulli | gaussian
    fit_noise: bool = False
    mask_radius: int = 0
    use_ctf: bool = False


@dataclass(frozen=True)
class ModelConfig:
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    likelihood: LikelihoodConfig = field(default_factory=LikelihoodConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        d = json.loads(s)
        return ModelConfig(
            generator=GeneratorConfig(**d["generator"]),
            encoder=EncoderConfig(**d["encoder"]),
            likelihood=LikelihoodConfig(**d["likelihood"]),
        )


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters, as the JAX package's TrainConfig. The mesh
    fields run over a process group of dp * tp ranks: dp data shards; tp >
    1 shards the parameters and Adam's moments over the model axis, or with
    sp=True (modes B and C, either tier) the posterior's grid; host_stream
    and stream_bf16 are fit's host feed."""
    learning_rate: float = 2e-4
    minibatch_size: int = 100
    num_epochs: int = 500
    save_interval: int = 20
    log_root: str = "./training_logs"
    # ReduceLROnPlateau(mode='max', ...) equivalents (reference train_mnist.py:581)
    plateau_factor: float = 0.5
    plateau_patience: int = 9
    plateau_threshold: float = 1e-4
    min_lr: float = 0.0
    # EarlyStopping (reference train_mnist.py:614)
    early_patience: int = 20
    early_delta: float = 1e-4
    seed: int = 0
    compute_dtype: Optional[str] = None  # None=float32, or 'bfloat16'
    dp: int = 1
    tp: int = 1
    sp: bool = False
    host_stream: bool = False
    stream_bf16: bool = False


def fourier_sigma_for(image_dim: int) -> float:
    """Reference train_mnist.py:511 — sigma = pixel pitch 2/(dim-1)."""
    return 2.0 / (image_dim - 1)
