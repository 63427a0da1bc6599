"""The contrast transfer function of cryo-EM, plain PyTorch in float64.

The physics of the reference's src/ctf.py: an astigmatism-free defocus df,
the phase gamma = 2 pi (-df lambda s^2 / 2 + Cs lambda^3 s^4 / 4) with the
relativistic electron wavelength lambda, amplitude-contrast mixing
sqrt(1 - w^2) sin(gamma) - w cos(gamma) and a B-factor envelope. The
real-space kernel of a particle is -fftshift(ifft2(CTF)).real over a k x k
grid of frequencies (k odd), which the Gaussian likelihood cross-correlates
with the decoded image ('same' size; the kernel is even under a half turn,
so correlation and convolution agree).
"""

from __future__ import annotations

import math

import torch


def ctf_kernels(table: dict, k: int, device) -> torch.Tensor:
    """(N, k, k) float32 real-space kernels of the N rows of `table`:
    {"defocus": um, "cs": mm, "voltage": kV, "apix": A, "ampcont": %,
    "bfactor": A^2}, each an (N,) tensor or sequence."""
    col = lambda name: torch.as_tensor(table[name], dtype=torch.float64,
                                       device=device)[:, None, None]
    f = torch.fft.fftfreq(k, dtype=torch.float64, device=device)
    fy, fx = torch.meshgrid(f, f, indexing="ij")
    apix = col("apix")
    s2 = (fx ** 2 + fy ** 2)[None] / apix ** 2                  # 1 / A^2
    volt = col("voltage") * 1e3
    lam = 12.2639 / torch.sqrt(volt + 0.97845e-6 * volt ** 2)    # A
    df = col("defocus") * 1e4                                    # A
    cs = col("cs") * 1e7                                         # A
    w = col("ampcont") / 100.0
    gamma = 2 * math.pi * (-0.5 * df * lam * s2
                           + 0.25 * cs * lam ** 3 * s2 ** 2)
    ctf = torch.sqrt(1 - w ** 2) * torch.sin(gamma) - w * torch.cos(gamma)
    ctf = ctf * torch.exp(-col("bfactor") / 4 * s2)
    kern = -torch.fft.fftshift(torch.fft.ifft2(ctf), dim=(-2, -1)).real
    return kern.float()


def correlate_same(images: torch.Tensor, kernels: torch.Tensor
                   ) -> torch.Tensor:
    """Each image (B, n, n) cross-correlated with its own kernel (B, k, k),
    'same' size with zero padding: the reference's grouped conv2d
    (groups=B, padding k // 2)."""
    b, n, _ = images.shape
    k = kernels.shape[-1]
    out = torch.nn.functional.conv2d(images[None], kernels[:, None],
                                     padding=k // 2, groups=b)
    return out[0]
