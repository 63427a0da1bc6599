"""The clustering algorithms of the clustering CLIs, without scikit-learn
(the counterparts of the JAX package's run_clustering, which calls
scikit-learn's KMeans and AgglomerativeClustering).

kmeans: Lloyd's algorithm on the device, all restarts at once as one batch,
seeded as scikit-learn's KMeans seeds by default (greedy k-means++ with
2 + floor(ln k) local trials), stopped as it stops (the squared shift of
the centres at most tol times the mean variance of the features, or the
labels unchanged, or max_iter rounds), the restart of least inertia kept.
An empty cluster keeps its centre (scikit-learn moves it to a far point).
Every draw comes from one explicit torch.Generator on the data's device.

ward: Ward's agglomeration on the host through scipy's linkage, the tree
cut into n_clusters flat clusters, labelled 0..n_clusters-1.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..models.targetvae import resolve_device


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances of the points x (N, d) to the centres c (..., k, d):
    (..., N, k), never below 0."""
    d = ((x * x).sum(-1)[:, None] - 2.0 * x @ c.transpose(-1, -2)
         + (c * c).sum(-1)[..., None, :])
    return d.clamp_min_(0.0)


def kmeans_plusplus(x: torch.Tensor, k: int, n_init: int,
                    generator: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ seeds of n_init restarts at once: (n_init, k, d).
    Each centre after the first is the best, by the potential it leaves, of
    2 + floor(ln k) points drawn with probability proportional to their
    squared distance to the nearest centre so far."""
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    dev = x.device
    rows = torch.arange(n_init, device=dev)
    first = torch.randint(0, n, (n_init,), generator=generator, device=dev)
    centers = [x[first]]                                     # (I, d) each
    closest = _sq_dists(x, x[first][:, None])[..., 0]        # (I, N)
    pot = closest.sum(1)                                     # (I,)
    for _ in range(1, k):
        u = torch.rand((n_init, trials), generator=generator, device=dev,
                       dtype=x.dtype) * pot[:, None]
        cand = torch.searchsorted(closest.cumsum(1), u).clamp_max_(n - 1)
        dist = torch.minimum(closest[:, None],
                             _sq_dists(x, x[cand]).transpose(1, 2))
        cpot = dist.sum(2)                                   # (I, trials)
        best = cpot.argmin(1)
        pot = cpot[rows, best]
        closest = dist[rows, best]
        centers.append(x[cand[rows, best]])
    return torch.stack(centers, dim=1)


def kmeans(z: np.ndarray, n_clusters: int, n_init: int = 100,
           max_iter: int = 300, tol: float = 1e-4, seed: int = 0,
           device=None) -> Tuple[np.ndarray, float]:
    """k-means of the rows of z (N, d) on `device` (None: cuda:0, raising
    without CUDA; pass device="cpu" for the host), float64. Returns
    (labels (N,) int64, inertia) of the best of n_init restarts."""
    x = torch.as_tensor(np.asarray(z, np.float64),
                        device=resolve_device(device))
    x = x - x.mean(0)                 # as scikit-learn does, for precision
    gen = torch.Generator(device=x.device).manual_seed(seed)
    bound = float(x.var(0, unbiased=False).mean()) * tol
    centers = kmeans_plusplus(x, n_clusters, n_init, gen)    # (I, k, d)
    labels = _sq_dists(x, centers).argmin(-1)                # (I, N)
    live = torch.ones(n_init, dtype=torch.bool, device=x.device)
    ones = torch.ones_like(x[:, 0])
    for _ in range(max_iter):
        onehot = torch.zeros((n_init, n_clusters, x.shape[0]),
                             dtype=x.dtype, device=x.device)
        onehot.scatter_(1, labels[:, None], 1.0)
        counts = onehot @ ones                               # (I, k)
        sums = onehot @ x                                    # (I, k, d)
        new = torch.where(counts[..., None] > 0,
                          sums / counts.clamp_min(1.0)[..., None], centers)
        new = torch.where(live[:, None, None], new, centers)
        shift = ((new - centers) ** 2).sum((1, 2))
        new_labels = _sq_dists(x, new).argmin(-1)
        same = (new_labels == labels).all(1)
        centers = new
        labels = torch.where(live[:, None], new_labels, labels)
        live &= ~(same | (shift <= bound))
        if not bool(live.any()):
            break
    d = _sq_dists(x, centers)
    labels = d.argmin(-1)
    inertia = d.gather(-1, labels[..., None])[..., 0].sum(1)
    best = int(inertia.argmin())
    return labels[best].cpu().numpy(), float(inertia[best])


def ward(z: np.ndarray, n_clusters: int) -> np.ndarray:
    """Ward's agglomerative clustering of the rows of z, cut into
    n_clusters flat clusters: labels (N,) in 0..n_clusters-1."""
    from scipy.cluster.hierarchy import fcluster, linkage
    tree = linkage(np.asarray(z, np.float64), "ward")
    flat = fcluster(tree, n_clusters, "maxclust")
    return np.unique(flat, return_inverse=True)[1].astype(np.int64)

