"""Checkpoint loading and batched latent extraction for clustering and
evaluation (mirror of targetvae_tpu/cli/clustering_common.py::load_encoder
and embed_dataset).

The rest of that module (clustering, accuracy, pose correlations, figures)
is not ported yet (ROADMAP.md, queue 1, item 15), nor the reading of the
reference's pickled torch .sav files (item 26).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.targetvae import TargetVAE
from ..train.checkpoint import load_checkpoint
from ..utils.jax_params import params_from_jax


def load_encoder(path_to_encoder: str, device=None) -> Tuple[TargetVAE, dict]:
    """Load an inference.sav checkpoint written by either package ->
    (model, params): the model on `device` (None: cuda:0) and params
    {"encoder": tensors there}, which model.embed takes."""
    with open(path_to_encoder, "rb") as f:
        head = f.read(2)
    if head == b"PK" or head[:1] == b"\x80":
        raise NotImplementedError(
            f"{path_to_encoder} is a reference torch checkpoint; reading "
            "those is not ported yet (ROADMAP.md, queue 1, item 26)")
    params, cfg, _ = load_checkpoint(path_to_encoder)
    model = TargetVAE(cfg, device)
    return model, params_from_jax(params, model.device)


def _dtype(compute_dtype):
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if compute_dtype in (None, "float32"):
        return None
    raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")


def embed_dataset(model: TargetVAE, params: dict, images: np.ndarray,
                  minibatch_size: int = 100, compute_dtype=None,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (z_values (N, 2*zd), rot_pred (N, 1), tr_pred (N, 2)).

    images: (N, H, W, C) numpy, run in batches of `minibatch_size` on the
    model's device, the ragged tail as one smaller batch. compute_dtype: None
    (float32) or 'bfloat16' (the serving tier, on the fused kernels)."""
    dt = _dtype(compute_dtype)
    zs, rots, trs = [], [], []
    n = len(images)
    b = minibatch_size
    starts = list(range(0, n - n % b, b)) + ([n - n % b] if n % b else [])
    with torch.inference_mode():
        for i in starts:
            y = torch.from_numpy(np.ascontiguousarray(
                images[i:i + b], dtype=np.float32)).to(model.device)
            out = model.embed(params, y, compute_dtype=dt)
            zs.append(out["z_content"].cpu().numpy())
            rots.append(out["theta_mu"].cpu().numpy())
            trs.append(out["dx"].cpu().numpy())
    return np.concatenate(zs), np.concatenate(rots), np.concatenate(trs)
