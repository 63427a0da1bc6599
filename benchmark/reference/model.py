"""TARGET-VAE in plain float32 PyTorch: the benchmark's reference.

Mode C of the reference's src/models.py and train_mnist.py /
train_particles.py, written from the model's equations with no kernel, no
cache and no batching trick: a lifting group convolution whose R rotated
filter copies are bilinear resamplings of one filter bank (the reference's
affine_grid + grid_sample, as static tables), a 1x1 mixing layer and three
1x1 heads at every (position, rotation); a joint posterior over the R x H'
x W' cells; a coordinate MLP on random Fourier features as the decoder; a
Bernoulli or a Gaussian likelihood, the latter with each particle's CTF and
a circular mask; the KL of the reference's ELBO.

The ELBO takes the step's sampling noise (noise.py) or none: without it
the posterior itself is the sample and the reparameterisation noise is zero;
with it the attention sample is softmax(logits + Gumbel noise), the pose and
the latent are its moments plus their standard deviations times the normal
noise, and the KL is the posterior's own, as in the reference's training.
The embedding is deterministic.

Every matrix product and convolution goes through `prec` (EXACT: plain
float32). The correctness control passes one that computes them in a lower
precision, so that the same code computes the reference in that precision.

Parameters are nested dicts of tensors: {"encoder": {"conv1": {"w" (K, C,
1, k, k), "b"}, "conv2", "conv_a", "conv_r", "conv_z": {"w" (in, out),
"b"}}, "generator": {"fourier": {"w" (2, F), "b" (F,)}, "coord_linear",
"latent_linear" ({"w"} only), "hidden": [...], "out"}}. The configuration
is the "model" section of a configuration file: plain dicts.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .ctf import correlate_same

LEAKY_SLOPE = 0.01          # torch's nn.LeakyReLU default, as the reference
EPS = 1e-6


class Exact:
    """The reference's products and convolutions: plain float32."""

    @staticmethod
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b

    @staticmethod
    def conv(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
        return F.conv2d(x, w, padding=padding)


EXACT = Exact()


def act(h: torch.Tensor, kind: str) -> torch.Tensor:
    return torch.tanh(h) if kind == "tanh" else F.leaky_relu(h, LEAKY_SLOPE)


# ---------------------------------------------------------------- geometry

def attn_dim(enc: dict) -> int:
    return enc["image_dim"] + 2 * enc["padding"] - enc["kernels_size"] + 1


def image_grid(n: int) -> np.ndarray:
    """Pixel centres in [-1, 1]^2, y descending, (n*n, 2)."""
    x0, x1 = np.meshgrid(np.linspace(-1, 1, n), np.linspace(1, -1, n))
    return np.stack([x0.ravel(), x1.ravel()], axis=1).astype(np.float32)


def attention_grid(d: int, n: int) -> np.ndarray:
    """The d x d translation cells at the pixel pitch s = 2 / (n - 1):
    -s (d // 2) + i s, y descending, (d*d, 2)."""
    s = 2.0 / (n - 1)
    xs = -s * (d // 2) + s * np.arange(d)
    x0, x1 = np.meshgrid(xs, xs[::-1])
    return np.stack([x0.ravel(), x1.ravel()], axis=1).astype(np.float32)


def group_offsets(R: int) -> np.ndarray:
    ang = 2.0 * np.pi * np.arange(R) / R
    return np.where(ang > np.pi + 1e-9, ang - 2.0 * np.pi, ang
                    ).astype(np.float32)


def rotation_log_prior(enc: dict, R: int) -> np.ndarray:
    """log p(r): uniform over (-2 pi, 2 pi) with rotation refinement (the
    density of U(-2 pi, 2 pi)), or N(offset; 0, theta_prior) with
    normal_prior_over_r."""
    if enc["normal_prior_over_r"]:
        sig, offs = enc["theta_prior"], group_offsets(R)
        return (-0.5 * np.log(2 * np.pi) - np.log(sig)
                - 0.5 * (offs / sig) ** 2).astype(np.float32)
    return np.full(R, -np.log(4 * np.pi), dtype=np.float32)


def translation_log_prior(grid: np.ndarray) -> np.ndarray:
    """log p(t): N(0, 0.1) in each coordinate, normalised over the cells."""
    std = 0.1
    lp = (-0.5 * np.log(2 * np.pi) - np.log(std)
          - 0.5 * (grid / std) ** 2).sum(axis=1)
    lp = lp - (lp.max() + np.log(np.exp(lp - lp.max()).sum()))
    return lp.astype(np.float32)


@functools.lru_cache(maxsize=None)
def rotation_tables(k: int, R: int):
    """Bilinear resampling of a k x k filter rotated by 2 pi r / R, as
    F.affine_grid(align_corners=False) + F.grid_sample with zero padding
    sample it: (R, k*k, 4) source indices and weights."""
    xs = (2.0 * np.arange(k) + 1.0) / k - 1.0
    gy, gx = np.meshgrid(xs, xs, indexing="ij")
    idx = np.zeros((R, k * k, 4), dtype=np.int64)
    wts = np.zeros((R, k * k, 4), dtype=np.float64)
    for r in range(R):
        th = 2.0 * np.pi * r / R
        c, s = np.cos(th), np.sin(th)
        ix = ((c * gx + s * gy + 1.0) * k - 1.0) / 2.0
        iy = ((-s * gx + c * gy + 1.0) * k - 1.0) / 2.0
        x0, y0 = np.floor(ix), np.floor(iy)
        fx, fy = ix - x0, iy - y0
        for ci, (dy, dx, w) in enumerate([(0, 0, (1 - fy) * (1 - fx)),
                                          (0, 1, (1 - fy) * fx),
                                          (1, 0, fy * (1 - fx)),
                                          (1, 1, fy * fx)]):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < k) & (yi >= 0) & (yi < k)
            idx[r, :, ci] = np.where(ok, yi * k + xi, 0).ravel()
            wts[r, :, ci] = np.where(ok, w, 0.0).ravel()
    return idx, wts.astype(np.float32)


def rotated_filters(w: torch.Tensor, R: int) -> torch.Tensor:
    """(K, C, 1, k, k) -> the conv weight (R*K, C, k, k), rotation-major."""
    K, C, _, k, _ = w.shape
    idx, wts = rotation_tables(k, R)
    idx = torch.as_tensor(idx, device=w.device)
    wts = torch.as_tensor(wts, device=w.device)
    g = w.reshape(K * C, k * k)[:, idx]                    # (KC, R, kk, 4)
    rot = torch.einsum("orkc,rkc->rok", g, wts)
    return rot.reshape(R * K, C, k, k)


# ----------------------------------------------------------------- encoder

def encoder_cells(params: dict, enc: dict, y: torch.Tensor,
                  prec=EXACT) -> dict:
    """The heads at every cell of images y (B, n, n, C): attention logits
    with log p(r) added, theta means with the rotation offsets added, theta
    log-stds, z means and log-stds, each (B, H', W', R[, zd])."""
    p = params["encoder"]
    R, K, zd, kind = enc["groupconv"], enc["kernels_num"], enc["z_dim"], \
        enc["activation"]
    x = y.permute(0, 3, 1, 2)
    w = rotated_filters(p["conv1"]["w"], R)
    lift = prec.conv(x, w, enc["padding"])
    b, _, hp, wp = lift.shape
    lift = lift.permute(0, 2, 3, 1).reshape(b, hp, wp, R, K)
    h = act(lift + p["conv1"]["b"], kind)
    h = act(prec.mm(h, p["conv2"]["w"]) + p["conv2"]["b"], kind)
    wh = torch.cat([p["conv_a"]["w"], p["conv_r"]["w"], p["conv_z"]["w"]], 1)
    bh = torch.cat([p["conv_a"]["b"], p["conv_r"]["b"], p["conv_z"]["b"]])
    out = prec.mm(h, wh) + bh                            # (B, H', W', R, D)
    log_pr = torch.as_tensor(rotation_log_prior(enc, R), device=y.device)
    offsets = torch.as_tensor(group_offsets(R), device=y.device)
    return {"attn": out[..., 0] + log_pr, "theta_mu": out[..., 1] + offsets,
            "theta_logstd": out[..., 2], "z_mu": out[..., 3:3 + zd],
            "z_logstd": out[..., 3 + zd:3 + 2 * zd]}


def embed(params: dict, enc: dict, y: torch.Tensor, prec=EXACT):
    """The clustering embedding: z_content = [z_mu; z_std] and theta_mu at
    the most probable cell, dx the posterior's expected translation. Returns
    (z_content (B, 2 zd), theta (B, 1), dx (B, 2)) and the cells."""
    cells = encoder_cells(params, enc, y, prec)
    b = y.shape[0]
    flat = cells["attn"].reshape(b, -1)
    best = flat.argmax(dim=1)
    rows = torch.arange(b, device=y.device)
    zd = enc["z_dim"]
    z_mu = cells["z_mu"].reshape(b, -1, zd)[rows, best]
    z_std = cells["z_logstd"].reshape(b, -1, zd)[rows, best].exp()
    theta = cells["theta_mu"].reshape(b, -1)[rows, best][:, None]
    grid = torch.as_tensor(attention_grid(attn_dim(enc), enc["image_dim"]),
                           device=y.device)
    a_locs = torch.softmax(flat, dim=1).reshape(cells["attn"].shape).sum(3)
    dx = a_locs.reshape(b, -1) @ grid
    return torch.cat([z_mu, z_std], dim=1), theta, dx, cells


# ----------------------------------------------------------------- decoder

def decode(params: dict, gen: dict, coords: torch.Tensor, z: torch.Tensor,
           prec=EXACT) -> torch.Tensor:
    """coords (B, N, 2), z (B, zd) -> (B, N, n_out)."""
    p = params["generator"]
    kind = gen["activation"]
    feats = torch.cos(coords @ (p["fourier"]["w"] / gen["fourier_sigma"])
                      + p["fourier"]["b"])
    h = prec.mm(feats, p["coord_linear"]["w"]) + p["coord_linear"]["b"]
    h = h + prec.mm(z, p["latent_linear"]["w"])[:, None, :]
    h = act(h, kind)
    for layer in p["hidden"]:
        h = act(prec.mm(h, layer["w"]) + layer["b"], kind)
    return prec.mm(h, p["out"]["w"]) + p["out"]["b"]


def posed_coords(n: int, dx: torch.Tensor, theta: torch.Tensor):
    """The image grid translated by -dx, then rotated by theta: (B, n*n,
    2)."""
    x = torch.as_tensor(image_grid(n), device=dx.device)[None] - dx[:, None]
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    return torch.stack([x[..., 0] * c - x[..., 1] * s,
                        x[..., 0] * s + x[..., 1] * c], dim=-1)


# -------------------------------------------------------------- likelihood

def _mask(dx: torch.Tensor, n: int, radius: int) -> torch.Tensor:
    """The pixels within `radius` of the inferred centre dx (in pixels)."""
    xs = torch.arange(-(n // 2), n - n // 2, dtype=torch.float32,
                      device=dx.device)
    ys = torch.arange(n // 2, n // 2 - n, -1, dtype=torch.float32,
                      device=dx.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1)
    centre = dx.detach() / (2.0 / (n - 1))
    return ((centre[:, None] - grid[None]) ** 2).sum(-1).sqrt() < radius


def log_likelihood(y_hat: torch.Tensor, y: torch.Tensor, lik: dict,
                   dx: torch.Tensor, ctf) -> torch.Tensor:
    """Batch mean of log p(y | decoded): Bernoulli on logits (a BCE mean
    times the pixels), or Gaussian of unit variance, the decoded mean
    filtered by each image's CTF and both masked."""
    b, n = y.shape[0], y.shape[1]
    if lik["kind"] == "bernoulli":
        logits, t = y_hat.reshape(b, -1), y.reshape(b, -1)
        bce = F.binary_cross_entropy_with_logits(logits, t, reduction="none")
        return -bce.mean() * t.shape[1]
    mu = y_hat[..., 0].reshape(b, n, n)
    if ctf is not None:
        mu = correlate_same(mu, ctf)
    mu, t = mu.reshape(b, -1), y.reshape(b, -1)
    if lik["mask_radius"] > 0:
        m = _mask(dx, n, lik["mask_radius"])
        mu, t = torch.where(m, mu, 0.0), torch.where(m, t, 0.0)
    return -0.5 * ((mu - t) ** 2).sum(1).mean()


# -------------------------------------------------------------------- ELBO

def _normal_kl(mu_q, std_q, mu_p, std_p):
    ratio = (std_q / std_p) ** 2
    return 0.5 * (ratio + ((mu_q - mu_p) / std_p) ** 2 - 1.0
                  - torch.log(ratio))


def elbo(params: dict, model: dict, y: torch.Tensor, ctf=None,
         prec=EXACT, noise=None):
    """(elbo, log_p, kl), batch means, of images y (B, n, n, C) with their
    CTF kernels where the likelihood uses them; sampled with `noise`
    (noise.step_noise's "gumbel", "z" and "theta" for these rows), or
    deterministic without."""
    enc, gen, lik = model["encoder"], model["generator"], model["likelihood"]
    R, zd, n = enc["groupconv"], enc["z_dim"], enc["image_dim"]
    c = encoder_cells(params, enc, y, prec)
    b = y.shape[0]
    d = attn_dim(enc)
    grid_np = attention_grid(d, n)
    grid = torch.as_tensor(grid_np, device=y.device)
    log_pt = torch.as_tensor(translation_log_prior(grid_np), device=y.device)
    log_pr = torch.as_tensor(rotation_log_prior(enc, R), device=y.device)
    log_prior = torch.log_softmax((log_pt[:, None] + log_pr).reshape(-1), 0)
    offsets = torch.as_tensor(group_offsets(R), device=y.device)

    q = torch.log_softmax(c["attn"].reshape(b, -1), dim=1)   # (B, M R)
    a = q.exp()
    z_mu = c["z_mu"].reshape(b, -1, zd)
    z_std = c["z_logstd"].reshape(b, -1, zd).exp() + EPS
    th_mu = c["theta_mu"].reshape(b, -1)
    th_std = c["theta_logstd"].reshape(b, -1).exp() + EPS
    s = a if noise is None else torch.softmax(
        c["attn"].reshape(b, -1) + noise["gumbel"], dim=1)
    z = torch.einsum("bmz,bm->bz", z_mu, s)
    theta = (th_mu * s).sum(1)
    dx = s.reshape(b, d * d, R).sum(2) @ grid
    if noise is not None:
        z = z + torch.einsum("bmz,bm->bz", z_std, s) * noise["z"]
        theta = theta + (th_std * s).sum(1) * noise["theta"]

    # the reference's guards: where exp(q) underflows to 0 the moments
    # become (0, 1), so that 0 * KL stays 0
    dead = a == 0.0
    zq_mu = torch.where(dead[..., None], 0.0, z_mu)
    zq_std = torch.where(dead[..., None], 1.0, z_std)
    tq_mu = torch.where(dead, 0.0, th_mu)
    tq_std = torch.where(dead, 1.0, th_std)
    kl_z = _normal_kl(zq_mu, zq_std, 0.0, 1.0).sum(-1)
    kl_th = _normal_kl(tq_mu, tq_std, offsets.repeat(d * d), math.pi / R)
    kl = ((a * (q - log_prior)).sum(1) + (a * (kl_th + kl_z)).sum(1)).mean()

    y_hat = decode(params, gen, posed_coords(n, dx, theta), z, prec)
    log_p = log_likelihood(y_hat, y, lik, dx, ctf)
    return log_p - kl, log_p, kl
