"""Parameter initializers matching the torch defaults the reference relies on.

nn.Linear / nn.Conv2d default to U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both
weight and bias; the reference GroupConv uses the same bound explicitly
(src/models.py:161-169). Every draw comes from an explicit torch.Generator,
made on the generator's device and then moved to `device`.
"""

from __future__ import annotations

import math

import torch


def _uniform(generator: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device)


def linear_init(generator: torch.Generator, n_in: int, n_out: int,
                bias: bool = True, device=None) -> dict:
    """Weight stored (n_in, n_out) so the math reads x @ w; bias (n_out,)."""
    bound = 1.0 / math.sqrt(n_in)
    p = {"w": _uniform(generator, (n_in, n_out), bound, device)}
    if bias:
        p["b"] = _uniform(generator, (n_out,), bound, device)
    return p


def conv2d_init(generator: torch.Generator, in_channels: int,
                out_channels: int, kernel_size: int, bias: bool = True,
                device=None) -> dict:
    """Weight stored (out, in, k, k) (the reference's Conv2d layout)."""
    bound = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
    p = {"w": _uniform(generator, (out_channels, in_channels, kernel_size,
                                   kernel_size), bound, device)}
    if bias:
        p["b"] = _uniform(generator, (out_channels,), bound, device)
    return p


def groupconv_init(generator: torch.Generator, in_channels: int,
                   out_channels: int, kernel_size: int, input_rot_dim: int = 1,
                   bias: bool = True, device=None) -> dict:
    """Weight stored (out, in, rot_in, k, k) (reference src/models.py:151)."""
    fan_in = in_channels * kernel_size * kernel_size  # reference bound ignores rot_in
    bound = 1.0 / math.sqrt(fan_in)
    p = {"w": _uniform(generator, (out_channels, in_channels, input_rot_dim,
                                   kernel_size, kernel_size), bound, device)}
    if bias:
        p["b"] = _uniform(generator, (out_channels,), bound, device)
    return p
