"""Coordinate grids and rigid 2-D transforms (mirror of targetvae_tpu/ops/coords.py).

  - image grid in [-1, 1]^2 with y descending (reference train_mnist.py:475-479)
  - attention grid with odd/even pixel-count handling
    (reference train_mnist.py:112-121)
  - per-sample translate-then-rotate coordinate transform
    (reference train_mnist.py:70-78, 233-239)
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def image_grid(image_dim: int) -> np.ndarray:
    """Pixel-center coordinates in [-1,1]^2, y descending; shape (N, 2), N=dim^2."""
    xgrid = np.linspace(-1, 1, image_dim)
    ygrid = np.linspace(1, -1, image_dim)
    x0, x1 = np.meshgrid(xgrid, ygrid)
    coords = np.stack([x0.ravel(), x1.ravel()], axis=1)
    return coords.astype(np.float32)


@functools.lru_cache(maxsize=None)
def attention_grid(attn_dim: int, image_dim: int) -> np.ndarray:
    """Coordinates of attention-map cells; shape (attn_dim*attn_dim, 2).

    The pixel pitch is s = 2/(image_dim-1). Odd grids span [-s*(d//2),
    s*(d//2)]; even grids span [-s*(d//2), s*(d//2 - 1)]: both are the d
    values -s*(d//2) + i*s. y runs descending.
    """
    s = 2.0 / (image_dim - 1)
    d = attn_dim
    x_grid = -s * (d // 2) + s * np.arange(d)
    y_grid = x_grid[::-1].copy()
    x0, x1 = np.meshgrid(x_grid, y_grid)
    coords = np.stack([x0.ravel(), x1.ravel()], axis=1)
    return coords.astype(np.float32)


def transform_coords(x: torch.Tensor, dx: torch.Tensor,
                     theta: torch.Tensor) -> torch.Tensor:
    """Translate then rotate pixel coordinates: (x - dx) @ R(theta) with
    R = [[cos, sin], [-sin, cos]].

    x: (N, 2) or (B, N, 2); dx: (B, 2); theta: (B,). Returns (B, N, 2).
    """
    if x.dim() == 2:
        x = x[None]
    x = x - dx[:, None, :]
    c = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    x0, x1 = x[..., 0], x[..., 1]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
