"""TargetVAE: encoder + generator + likelihood in one model
(mirror of targetvae_tpu/models/targetvae.py).

`init` draws the parameters from a torch.Generator, installs them in the
module and returns them as a nested dict (the JAX package's pytree layout);
the other methods are functions of (params, inputs) like the JAX ones.
`embed` reproduces the reference clustering embedding get_latent
(clustering_mnist.py:45-164): argmax posterior cell (no sampling),
z_content = [z_mu; z_std] at the best cell, theta = theta_mu there, and
dx = the softmax-expected grid coordinate (marginalised over rotations in
mode C); in mode A the Gaussian's own means.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.coords import attention_grid, image_grid
from ..utils.config import ModelConfig
from ..utils.trace import span
from .encoders import Encoder, encoder_apply, encoder_init
from .generator import SpatialGenerator, generator_apply, generator_init


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one named, else cuda:0. With no
    device named and no CUDA device present it raises; it never falls back
    to the CPU, which a caller has to ask for (device="cpu"). A bare "cuda"
    means cuda:0, so that two names of one device compare equal."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            return torch.device("cuda", 0)
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this package runs on cuda:0 by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


class TargetVAE(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        """device: where init puts the parameters and the entry points run;
        None means cuda:0 (resolve_device)."""
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.encoder: Optional[Encoder] = None
        self.spatial_generator: Optional[SpatialGenerator] = None

    def init(self, generator: torch.Generator) -> dict:
        params = {
            "generator": generator_init(generator, self.cfg.generator,
                                        self.device),
            "encoder": encoder_init(generator, self.cfg.encoder, self.device),
        }
        self.load_params(params)
        return self.params()

    def load_params(self, params: dict) -> None:
        """Install a nested dict of tensors (as init returns, or
        utils.jax_params.params_from_jax) as this module's parameters."""
        self.encoder = Encoder(self.cfg.encoder, params["encoder"])
        self.spatial_generator = SpatialGenerator(self.cfg.generator,
                                                  params["generator"])

    def params(self) -> dict:
        return {"generator": self.spatial_generator.params(),
                "encoder": self.encoder.params()}

    def elbo(self, params: dict, x_coord: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None, compute_dtype=None,
             ctf: Optional[torch.Tensor] = None):
        from ..losses.elbo import compute_elbo
        return compute_elbo(params, self.cfg, x_coord, y, generator,
                            compute_dtype=compute_dtype, ctf=ctf)

    def forward(self, y: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                compute_dtype=None):
        """(elbo, log_p, kl) of a batch with this module's own parameters."""
        return self.elbo(self.params(), self.base_grid(), y, generator,
                         compute_dtype)

    def decode(self, params: dict, x_coord: torch.Tensor, z: torch.Tensor,
               compute_dtype=None) -> torch.Tensor:
        with span("tvae.decoder"):
            return generator_apply(params["generator"], self.cfg.generator,
                                   x_coord, z, compute_dtype=compute_dtype)

    def base_grid(self) -> torch.Tensor:
        return torch.as_tensor(image_grid(self.cfg.encoder.image_dim),
                               device=self.device)

    def embed(self, params: dict, y: torch.Tensor, compute_dtype=None) -> dict:
        """y: (B, H, W, C). Returns z_content (B, 2*zd), theta_mu (B, 1),
        dx (B, 2)."""
        ecfg = self.cfg.encoder
        b = y.shape[0]
        enc = encoder_apply(params["encoder"], ecfg, y, None,
                            compute_dtype=compute_dtype)
        if ecfg.mode == "A":
            z_mu, z_std = enc["z_mu"], torch.exp(enc["z_logstd"])
            return {"z_content": torch.cat([z_mu[:, 3:], z_std[:, 3:]], dim=1),
                    "theta_mu": z_mu[:, 0:1], "dx": z_mu[:, 1:3]}
        attn = enc["attn"]
        flat = attn.reshape(b, -1)
        ind = torch.argmax(flat, dim=1)                              # (B,)
        rows = torch.arange(b, device=y.device)
        z_mu = enc["z_mu"].reshape(b, -1, ecfg.z_dim)
        z_std = torch.exp(enc["z_logstd"]).reshape(b, -1, ecfg.z_dim)
        z_content = torch.cat([z_mu[rows, ind], z_std[rows, ind]], dim=1)
        theta_best = enc["theta_mu"].reshape(b, -1)[rows, ind][:, None]
        grid = torch.as_tensor(attention_grid(attn.shape[1], ecfg.image_dim),
                               device=y.device)
        sm = torch.softmax(flat, dim=1)
        if ecfg.mode == "C":
            sm = sm.reshape(attn.shape).sum(dim=3).reshape(b, -1)
        dx = sm @ grid
        return {"z_content": z_content, "theta_mu": theta_best, "dx": dx}
