"""Lifting group convolution C -> P_R and the plain conv (mirror of
targetvae_tpu/ops/groupconv.py).

The R rotated filter copies come from the static gather tables
(ops/rotate.py) and run as one F.conv2d whose output channels are r-major
(index r*out + o), so the (R, out) split is a free reshape.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.trace import span
from .rotate import rotate_filter_bank


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, padding: int = 0,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain 2-D conv, channels last: x (B, H, W, C_in), weight (out, in, k,
    k). Returns (B, H', W', out) float32; with a compute dtype the conv runs
    in it and its output is cast back (as the JAX tier does)."""
    with span("tvae.lift"):
        xc, w = x.permute(0, 3, 1, 2), weight
        if compute_dtype is not None:
            xc, w = xc.to(compute_dtype), w.to(compute_dtype)
        y = F.conv2d(xc, w, padding=padding).float().permute(0, 2, 3, 1)
        return y if bias is None else y + bias


def lifted_weight(weight: torch.Tensor, R: int) -> torch.Tensor:
    """(out, in, rot_in, k, k) -> the OIHW conv weight (R*out, in*rot_in, k, k)
    with r-major output channels."""
    out, cin, rot_in, k, _ = weight.shape
    return rotate_filter_bank(weight, R).reshape(R * out, cin * rot_in, k, k)


def lifted_conv2d(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], R: int, padding: int = 0,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Lifting group conv.

    x: (B, H, W, C_in * rot_in) channels last; weight: (out, in, rot_in, k, k).
    Returns (B, H', W', R, out) float32. With a compute dtype, the conv runs
    in it and its output is cast back to float32 (as the JAX tier does).
    """
    out = weight.shape[0]
    with span("tvae.lift"):
        w = lifted_weight(weight, R)
        xc = x.permute(0, 3, 1, 2)
        if compute_dtype is not None:
            xc, w = xc.to(compute_dtype), w.to(compute_dtype)
        y = F.conv2d(xc, w, padding=padding).float()  # (B, R*out, H', W')
        b_, _, hp, wp = y.shape
        y = y.permute(0, 2, 3, 1).reshape(b_, hp, wp, R, out)
        if bias is not None:
            y = y + bias
        return y
