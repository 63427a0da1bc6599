"""t-SNE on the device, for the clustering CLIs' figures (the JAX package
calls scikit-learn's `TSNE(2, learning_rate=200.0, init="random")`, which
the card does not have).

It follows scikit-learn 1.9's Barnes-Hut recipe everywhere but in the
repulsion, which it computes exactly:
- P: each point's min(n - 1, 3 * perplexity + 1) nearest neighbours by
  squared Euclidean distance (float64), each row's binary search for
  beta to the perplexity (100 steps, entropy tolerance 1e-5, float64), P +
  P^T normalised to sum 1 (sklearn.manifold._t_sne._joint_probabilities_nn);
- the embedding: 1e-4 N(0, 1) from an explicit torch.Generator, float32;
- the descent (_gradient_descent): 250 iterations with P exaggerated 12x at
  momentum 0.5, then up to max_iter at momentum 0.8 with P as it is, each
  phase from fresh updates and gains; delta-bar-delta gains (+0.2 where
  the update and the gradient disagree in sign, x0.8 elsewhere, at least
  0.01); the error every 50 iterations and at the last, a phase stopped by
  n_iter_without_progress or a gradient norm of at most 1e-7;
- the gradient 4 (sum_j p_ij w_ij (y_i - y_j) - sum_j w_ij^2 (y_i - y_j) /
  Z), w_ij = 1 / (1 + |y_i - y_j|^2), Z = sum_{i != j} w_ij: the attraction
  over P's entries, the repulsion over all pairs in blocks of rows, so that
  no (N, N) array is held at once;
- the error KL(P || Q) over P's entries, as scikit-learn's.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

PERPLEXITY_TOLERANCE = 1e-5
SEARCH_STEPS = 100
EXPLORATION_ITER = 250
N_ITER_CHECK = 50
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
MACHINE_EPSILON = float(np.finfo(np.double).eps)
BLOCK_ELEMENTS = 1 << 24     # the (rows, N) entries of one repulsion block


def _rows(n: int, total: int) -> int:
    return max(1, min(n, total // max(n, 1)))


def nearest_neighbours(x: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, D). The k nearest other points of each row by squared
    Euclidean distance, in float64: (squared distances (N, k), indices
    (N, k))."""
    x = x.to(torch.float64)
    n = x.shape[0]
    sq = (x * x).sum(1)
    idx = []
    step = _rows(n, BLOCK_ELEMENTS)
    for a in range(0, n, step):
        b = min(n, a + step)
        d = sq[a:b, None] + sq[None, :] - 2.0 * (x[a:b] @ x.T)
        d[torch.arange(b - a, device=x.device),
          torch.arange(a, b, device=x.device)] = math.inf
        idx.append(torch.topk(d, k, dim=1, largest=False).indices)
    idx = torch.cat(idx)
    # the selected pairs' distances from their differences, not from the
    # expansion above, which loses the small ones
    return ((x[:, None, :] - x[idx]) ** 2).sum(-1), idx


def binary_search_perplexity(sqd: torch.Tensor, perplexity: float
                             ) -> torch.Tensor:
    """Each row's conditional P over its neighbours (scikit-learn's
    _utils._binary_search_perplexity, all rows at once): sqd (N, k)
    float64 -> P (N, k) float64, each row summing to 1."""
    n = sqd.shape[0]
    dev = sqd.device
    target = math.log(perplexity)
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    p = torch.zeros_like(sqd)
    for _ in range(SEARCH_STEPS):
        q = torch.exp(-sqd * beta[:, None])
        s = q.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        q = q / s[:, None]
        entropy = torch.log(s) + beta * (sqd * q).sum(1)
        diff = entropy - target
        p = torch.where(done[:, None], p, q)
        done = done | (diff.abs() <= PERPLEXITY_TOLERANCE)
        up = ~done & (diff > 0.0)
        down = ~done & (diff <= 0.0)
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(
            up, torch.where(torch.isinf(beta_max), beta * 2.0,
                            (beta + beta_max) / 2.0),
            torch.where(down, torch.where(torch.isinf(beta_min), beta / 2.0,
                                          (beta + beta_min) / 2.0), beta))
        if bool(done.all()):
            break
    return p


def joint_probabilities(x: torch.Tensor, perplexity: float = 30.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P of the points x (N, D), symmetric and summing to 1, as COO
    entries (rows, cols, values float64) in row-major order."""
    n = x.shape[0]
    k = min(n - 1, int(3.0 * perplexity + 1))
    sqd, idx = nearest_neighbours(x, k)
    cond = binary_search_perplexity(sqd, perplexity)
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    vals = cond.reshape(-1)
    # P + P^T: the entries of both directions, each pair's summed once
    key = torch.cat([rows * n + cols, cols * n + rows])
    pairs, inverse = torch.unique(key, return_inverse=True)
    v = torch.zeros(len(pairs), dtype=torch.float64,
                    device=x.device).index_add_(0, inverse,
                                                torch.cat([vals, vals]))
    return pairs // n, pairs % n, v / max(float(v.sum()), MACHINE_EPSILON)


class _Objective:
    """KL(P || Q) and its gradient at an embedding, P fixed."""

    def __init__(self, rows, cols, vals):
        self.rows, self.cols = rows, cols
        self.vals = vals.to(torch.float32)

    def __call__(self, y: torch.Tensor, exaggeration: float,
                 compute_error: bool):
        n, d = y.shape
        p = self.vals * exaggeration
        diff = y[self.rows] - y[self.cols]
        w_e = 1.0 / (1.0 + (diff * diff).sum(1))
        grad = torch.zeros_like(y).index_add_(0, self.rows,
                                              (p * w_e)[:, None] * diff)
        rep = torch.empty_like(y)
        z = torch.zeros((), dtype=torch.float64, device=y.device)
        step = _rows(n, BLOCK_ELEMENTS)
        for a in range(0, n, step):
            b = min(n, a + step)
            comps = [y[a:b, c:c + 1] - y[None, :, c] for c in range(d)]
            w = 1.0 / (1.0 + sum(t * t for t in comps))
            z = z + w.sum(dtype=torch.float64)
            w2 = w * w
            for c, t in enumerate(comps):
                rep[a:b, c] = (w2 * t).sum(1)
        z = z - n                                  # the diagonal's w_ii = 1
        grad = 4.0 * (grad - rep / z.to(torch.float32))
        if not compute_error:
            return None, grad
        q = (w_e.to(torch.float64) / z).clamp_min(FLOAT32_TINY)
        pe = p.to(torch.float64)
        err = float((pe * torch.log(pe.clamp_min(FLOAT32_TINY) / q)).sum())
        return err, grad


def _descent(objective, y, exaggeration, it, max_iter, momentum,
             learning_rate, n_iter_without_progress, min_gain=0.01,
             min_grad_norm=1e-7):
    """scikit-learn's _gradient_descent on y in place: (error, last
    iteration)."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        err, grad = objective(y, exaggeration, check or i == max_iter - 1)
        if err is not None:
            error = err
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min(min_gain)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y += update
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= min_grad_norm:
                break
    return error, i


def tsne(x, n_components: int = 2, perplexity: float = 30.0,
         early_exaggeration: float = 12.0, learning_rate: float = 200.0,
         max_iter: int = 1000, n_iter_without_progress: int = 300,
         seed: int = 0, device=None) -> Tuple[np.ndarray, float]:
    """The t-SNE embedding of x (N, D) on `device` (None: cuda:0, which
    raises without CUDA; the clustering CLIs pass the model's device):
    (embedding (N, n_components) float32, the final KL divergence)."""
    from ..models.targetvae import resolve_device

    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x), device=dev)
    n = x.shape[0]
    if not 0 < perplexity < n:
        raise ValueError(f"perplexity ({perplexity}) must be less than "
                         f"the number of points ({n})")
    rows, cols, vals = joint_probabilities(x.reshape(n, -1), perplexity)
    objective = _Objective(rows, cols, vals)
    y = 1e-4 * torch.randn((n, n_components), dtype=torch.float32,
                           generator=torch.Generator().manual_seed(seed))
    y = y.to(dev)
    _, it = _descent(objective, y, early_exaggeration, 0, EXPLORATION_ITER,
                     0.5, learning_rate, EXPLORATION_ITER)
    error = float("nan")
    if it < EXPLORATION_ITER or max_iter > EXPLORATION_ITER:
        error, it = _descent(objective, y, 1.0, it + 1, max_iter, 0.8,
                             learning_rate, n_iter_without_progress)
    return y.cpu().numpy(), error
