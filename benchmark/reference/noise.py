"""The sampling noise of one training step, drawn as the port's epoch loop
draws it, so that the reference can follow a sampled step.

A step of Trainer.train_epoch with a torch.Generator g (on the host) over a
batch of B rows draws, in this order: the epoch's order, randperm(B) (the
batch is the whole epoch here); the posterior's seed, randint(0, 2**31 - 1);
the latent noise, randn(B, zd); the rotation noise, randn(B). The Gumbel
noise of the attention sample, -log(-log(u)) with u clipped to [1e-20,
1 - 1e-7], is drawn per image from seed + image index for each cell (r, m):
on the card by the posterior kernel's counter-based Philox4x32-10 keyed by
seed + i and countered r * M + m (Random123's philox4x32 in integer
arithmetic; u from the first word's top 23 bits as a [1, 2) mantissa minus
1), on the host, where the port runs its plain tier, from a torch.Generator
seeded seed + i (u = rand(R, M)). These are the generators' definitions
written out again, not the port's code, which the reference does not
import.
"""

from __future__ import annotations

import torch

from .model import attn_dim

M32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """The high and low 32-bit words of a (a 32-bit constant) times b
    (32-bit values in int64), exact: b times each 16-bit half of a stays
    under 2**48."""
    p1 = b * (a & 0xFFFF)
    p2 = b * (a >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return (s >> 32) + (p2 >> 16), s & M32


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: counter a tuple
    of four, key a tuple of two (they broadcast). The four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


def philox_uniform(seed: int, b: int, R: int, M: int, device=None
                   ) -> torch.Tensor:
    """(b, R, M) uniforms as the posterior kernel draws them on the card."""
    key = ((int(seed) & 0x7FFFFFFF)
           + torch.arange(b, dtype=torch.int64, device=device))[:, None] & M32
    ctr = torch.arange(R * M, dtype=torch.int64, device=device)[None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    bits = philox4x32((ctr, zero, zero, zero), (key, zero))[0]
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u.reshape(b, R, M)


def host_uniform(seed: int, b: int, R: int, M: int) -> torch.Tensor:
    """(b, R, M) uniforms as the port's plain tier draws them on the host."""
    return torch.stack([torch.rand((R, M), generator=torch.Generator()
                                   .manual_seed(seed + i))
                        for i in range(b)]) if b else torch.empty(0, R, M)


def gumbel(seed: int, b: int, R: int, M: int, device) -> torch.Tensor:
    """(b, M * R) Gumbel noise of images 0..b-1 in the reference's cell order
    (position-major, rotation-minor), as the port draws it on `device`."""
    u = (philox_uniform(seed, b, R, M, device)
         if torch.device(device).type == "cuda"
         else host_uniform(seed, b, R, M).to(device))
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return g.transpose(1, 2).reshape(b, M * R)


def step_noise(g: torch.Generator, b: int, enc: dict, device) -> dict:
    """One step's draws from the host generator g, in the epoch loop's
    order: the rows' order, the attention sample's Gumbel noise, the latent
    and the rotation noise."""
    R, zd, d = enc["groupconv"], enc["z_dim"], attn_dim(enc)
    perm = torch.randperm(b, generator=g)
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=g))
    eps_z = torch.randn((b, zd), generator=g)
    eps_t = torch.randn((b,), generator=g)
    return {"perm": perm.to(device),
            "gumbel": gumbel(seed, b, R, d * d, device),
            "z": eps_z.to(device), "theta": eps_t.to(device)}


def rows(noise: dict, h: int) -> dict:
    """The noise of the first h rows."""
    return {k: v[:h] for k, v in noise.items()}
