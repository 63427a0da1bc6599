"""Static rotation-resampling tables for group-convolution filter banks
(mirror of targetvae_tpu/ops/rotate.py).

The reference rotates its lifting-conv filters every forward pass with
F.affine_grid + F.grid_sample (reference src/models.py:174-197). The angles
2*pi*r/R are static, so the bilinear gather indices and weights that
reproduce grid_sample(align_corners=False, zero padding) are built once in
numpy, and the rotation is one gather plus a weighted sum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def rotation_tables(k: int, R: int):
    """Bilinear resampling tables for R rotations of a k x k filter.

    Returns (idx, wts): idx int32 (R, k*k, 4) flat source-pixel indices and
    wts float32 (R, k*k, 4) bilinear weights (zero where the source falls
    outside the filter support).

    Convention of F.affine_grid(align_corners=False) with the reference's
    rotation matrix: output pixel centers at (2j+1)/k - 1, source coords
    x_in = c*x + s*y, y_in = -s*x + c*y, unnormalized by ix = ((x_in+1)*k-1)/2.
    """
    xs = (2.0 * np.arange(k) + 1.0) / k - 1.0
    gy, gx = np.meshgrid(xs, xs, indexing="ij")
    idx = np.zeros((R, k * k, 4), dtype=np.int32)
    wts = np.zeros((R, k * k, 4), dtype=np.float64)
    for r in range(R):
        th = 2.0 * np.pi * r / R
        c, s = np.cos(th), np.sin(th)
        ix = ((c * gx + s * gy + 1.0) * k - 1.0) / 2.0
        iy = ((-s * gx + c * gy + 1.0) * k - 1.0) / 2.0
        x0 = np.floor(ix)
        y0 = np.floor(iy)
        fx = ix - x0
        fy = iy - y0
        corners = [
            (0, 0, (1 - fy) * (1 - fx)),
            (0, 1, (1 - fy) * fx),
            (1, 0, fy * (1 - fx)),
            (1, 1, fy * fx),
        ]
        for ci, (dy, dxs, w) in enumerate(corners):
            xi = x0 + dxs
            yi = y0 + dy
            valid = (xi >= 0) & (xi < k) & (yi >= 0) & (yi < k)
            idx[r, :, ci] = np.where(valid, yi * k + xi, 0).astype(np.int64).ravel()
            wts[r, :, ci] = np.where(valid, w, 0.0).ravel()
    return idx, wts.astype(np.float32)


def rotate_filter_bank(weight: torch.Tensor, R: int) -> torch.Tensor:
    """R rotated copies of a filter bank.

    weight: (out, in, rot_in, k, k). Returns (R, out, in, rot_in, k, k) where
    entry r is the filter rotated by 2*pi*r/R.
    """
    out, cin, rot_in, k, _ = weight.shape
    idx_np, wts_np = rotation_tables(k, R)
    idx = torch.as_tensor(idx_np, dtype=torch.long, device=weight.device)
    wts = torch.as_tensor(wts_np, dtype=weight.dtype, device=weight.device)
    wf = weight.reshape(out * cin * rot_in, k * k)
    g = wf[:, idx]                                   # (OIr, R, kk, 4)
    rot = torch.einsum("orkc,rkc->rok", g, wts)
    return rot.reshape(R, out, cin, rot_in, k, k)
