"""Batched latent extraction for clustering and evaluation
(mirror of targetvae_tpu/cli/clustering_common.py::embed_dataset).

The rest of that module (checkpoint loading, clustering, accuracy, figures)
is not ported yet (ROADMAP.md, queue 1, item 15).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.targetvae import TargetVAE


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
