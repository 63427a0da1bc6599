"""Checkpoint loading, batched latent extraction, clustering, accuracy and
pose correlations for the clustering CLIs (mirror of
targetvae_tpu/cli/clustering_common.py), in numpy, scipy and torch.

The clustering itself runs on cli/clustering_algorithms.py (k-means on the
device, Ward on the host) where the JAX package calls scikit-learn; the
figures on cli/tsne.py and cli/figures.py where it calls scikit-learn's
TSNE and matplotlib. load_encoder reads this package's checkpoints and the
reference's pickled torch .sav files (utils/torch_import.py).
"""

from __future__ import annotations

import argparse
import sys
from typing import Tuple

import numpy as np
import torch

from ..models.targetvae import TargetVAE
from ..train.checkpoint import load_checkpoint
from ..utils.jax_params import params_from_jax
from ..utils.torch_import import is_torch_checkpoint, model_from_savs
from ..utils.trace import span
from .clustering_algorithms import kmeans, ward


def add_clustering_args(parser: argparse.ArgumentParser,
                        clustering: str = "agglomerative",
                        n_clusters: int = 10,
                        channels: Tuple[str, int] = ("--in-channels", 1)
                        ) -> argparse.ArgumentParser:
    """The flags every clustering CLI shares, with the JAX CLIs' names,
    defaults and types. The model's flags (-z, --t-inf, --r-inf,
    --activation and `channels`: galaxy's --in-channels 3, dSprites'
    --inp-channel) parse but are read by no one: load_encoder takes the
    model's config from the checkpoint."""
    ignored = "read from the checkpoint; ignored"
    parser.add_argument("-z", "--z-dim", type=int, default=2, help=ignored)
    parser.add_argument("--path-to-encoder",
                        help="path to the saved encoder model")
    parser.add_argument("--t-inf", default="attention",
                        choices=["unimodal", "attention"], help=ignored)
    parser.add_argument("--r-inf", default="attention+offsets",
                        choices=["unimodal", "attention", "attention+offsets"],
                        help=ignored)
    parser.add_argument("--clustering", default=clustering,
                        choices=["agglomerative", "k-means"],
                        help=f"agglomerative | k-means (default:{clustering})")
    parser.add_argument("--n-clusters", default=n_clusters, type=int,
                        help=f"Number of clusters (default:{n_clusters})")
    parser.add_argument(channels[0], type=int, default=channels[1],
                        help=ignored)
    parser.add_argument("--activation", choices=["tanh", "leakyrelu"],
                        default="leakyrelu", help=ignored)
    parser.add_argument("--minibatch-size", type=int, default=100)
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="embedding compute dtype: bfloat16 runs the "
                             "fused CUDA kernels on the card; float32 "
                             "bit-matches the reference protocol")
    parser.add_argument("-d", "--device", type=int, default=0)
    return parser


def load_encoder(path_to_encoder: str, device=None) -> Tuple[TargetVAE, dict]:
    """Load an inference.sav written by either package, or the reference's
    pickled torch inference.sav (utils/torch_import.py) -> (model, params):
    the model on `device` (None: cuda:0) and params {"encoder": tensors
    there[, "generator": ...]}, which model.embed takes."""
    if is_torch_checkpoint(path_to_encoder):
        print(f"# {path_to_encoder}: reference torch checkpoint, importing",
              file=sys.stderr)
        cfg, params = model_from_savs(path_to_encoder)
    else:
        params, cfg, _ = load_checkpoint(path_to_encoder)
    model = TargetVAE(cfg, device)
    return model, params_from_jax(params, model.device)


def _dtype(compute_dtype):
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if compute_dtype in (None, "float32"):
        return None
    raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")


class _Staging:
    """Batches of a host image array on their way to `device`. To a CUDA
    device each batch is copied into one of two pinned host buffers and from
    there without waiting (a buffer is refilled only once its last copy has
    ended), so the host queues the next batch while the card computes; to
    the CPU each batch is one float32 array."""

    def __init__(self, images: np.ndarray, b: int, device: torch.device):
        self.images, self.device = images, device
        self.bufs = ([torch.empty((b,) + images.shape[1:]).pin_memory()
                      for _ in range(2)] if device.type == "cuda" else None)
        self.done = [None, None]
        self.k = 0

    def batch(self, i: int, m: int) -> torch.Tensor:
        if self.bufs is None:
            return torch.from_numpy(np.ascontiguousarray(
                self.images[i:i + m], dtype=np.float32)).to(self.device)
        j, self.k = self.k, self.k ^ 1
        if self.done[j] is not None:
            self.done[j].synchronize()
        buf = self.bufs[j][:m]
        buf.numpy()[...] = self.images[i:i + m]
        y = buf.to(self.device, non_blocking=True)
        self.done[j] = torch.cuda.Event()
        self.done[j].record()
        return y


def embed_dataset(model: TargetVAE, params: dict, images: np.ndarray,
                  minibatch_size: int = 100, compute_dtype=None,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (z_values (N, 2*zd), rot_pred (N, 1), tr_pred (N, 2)).

    images: (N, H, W, C) numpy, run in batches of `minibatch_size` on the
    model's device, the ragged tail as one smaller batch. compute_dtype: None
    (float32) or 'bfloat16' (the serving tier, on the fused kernels). The
    batches reach the card through pinned buffers without a wait, and the
    outputs stay there until one copy to the host at the end."""
    dt = _dtype(compute_dtype)
    n = len(images)
    b = minibatch_size
    starts = list(range(0, n - n % b, b)) + ([n - n % b] if n % b else [])
    with span("tvae.embed"):
        staging = _Staging(images, b, model.device)
        outs = []
        with torch.inference_mode():
            for i in starts:
                with span("tvae.embed.stage"):
                    y = staging.batch(i, min(b, n - i))
                with span("tvae.embed.batch"):
                    out = model.embed(params, y, compute_dtype=dt)
                outs.append((out["z_content"], out["theta_mu"], out["dx"]))
        with span("tvae.embed.out"):
            zs, rots, trs = (torch.cat(parts).cpu().numpy()
                             for parts in zip(*outs))
    return zs, rots, trs


def cluster_acc(y_true: np.ndarray, y_pred: np.ndarray):
    """Hungarian-matching clustering accuracy (reference
    clustering_mnist.py:170-190): (mapping, accuracy)."""
    from scipy.optimize import linear_sum_assignment
    y_true = y_true.astype(np.int64)
    y_pred = y_pred.astype(np.int64)
    D = int(max(y_pred.max(), y_true.max())) + 1
    w = np.zeros((D, D), dtype=np.int64)
    np.add.at(w, (y_true, y_pred), 1)
    mapping = linear_sum_assignment(w.max() - w)
    total = w[mapping[0], mapping[1]].sum()
    return mapping, total / y_pred.shape[0]


def circular_corrcoef(a: np.ndarray, b: np.ndarray) -> float:
    """Fisher-Lee circular correlation (astropy.stats.circcorrcoef's
    formula)."""
    a = np.asarray(a, dtype=np.float64).ravel()
    b = np.asarray(b, dtype=np.float64).ravel()
    abar = np.arctan2(np.sin(a).sum(), np.cos(a).sum())
    bbar = np.arctan2(np.sin(b).sum(), np.cos(b).sum())
    sa = np.sin(a - abar)
    sb = np.sin(b - bbar)
    return float((sa * sb).sum() / np.sqrt((sa ** 2).sum() * (sb ** 2).sum()))


def measure_correlations(path_to_transformations: str, r_pred: np.ndarray,
                         t_pred: np.ndarray):
    """The circular correlation of the rotation and the Pearson correlations
    of the x and y translation with the ground truth (reference
    clustering_mnist.py:194-213): (r_corr, [x_corr, y_corr])."""
    t = np.load(path_to_transformations)
    rot_val = t[:, 0].reshape(-1, 1)
    t_val = t[:, 1:3]
    r_corr = circular_corrcoef(rot_val, np.asarray(r_pred))
    x_corr = np.corrcoef(t_val[:, 0], np.asarray(t_pred)[:, 0])[0][1]
    y_corr = np.corrcoef(t_val[:, 1], np.asarray(t_pred)[:, 1])[0][1]
    return r_corr, [x_corr, y_corr]


def run_clustering(z_values: np.ndarray, method: str, n_clusters: int,
                   device=None, seed: int = 0) -> np.ndarray:
    """The cluster labels of the rows of z_values: "agglomerative" (Ward's,
    on the host) or "k-means" (100 restarts on `device`, None cuda:0, which
    raises without CUDA; pass device="cpu" for the host), as the JAX
    package's scikit-learn calls."""
    if method == "agglomerative":
        return ward(z_values, n_clusters)
    if method != "k-means":
        raise ValueError(f"unknown clustering method {method!r}")
    return kmeans(z_values, n_clusters, n_init=100, seed=seed,
                  device=device)[0]


def write_results(path: str, encoder_path: str, acc=None, rot_corr=None,
                  tr_corr=None) -> None:
    """results.txt in the JAX package's words."""
    with open(path, "w") as f:
        f.write(f"using the encoder model from {encoder_path}\n\n")
        if acc is not None:
            f.write(f"The accuracy for clustering is {acc} \n")
        if rot_corr is not None:
            f.write(f"The circular correlation for the rotation is "
                    f"{rot_corr}\n")
        if tr_corr is not None:
            f.write(f"The Pearson correlation for the x and y values in the "
                    f"translation is {tr_corr}\n")
