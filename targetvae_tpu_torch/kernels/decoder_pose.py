"""Pose-aware fused decoder, forward (K7): separable Fourier phase.

Port of targetvae_tpu/kernels/decoder_pose.py::fused_pose_decoder (its `_fwd`
with save_res=False). The decoder's coordinates are an affine transform of
the regular pixel grid, x = (x0 - dx) @ R(theta) with x0[i, j] = (gx[j],
gy[i]), so the Fourier phase is separable:

    phase[i, j, f] = gx[j] * w0[f] + gy[i] * w1[f] + c[f]
    w'' = R(theta) @ (Wf / sigma) (per image),  c = bf - dx @ w''
    cos(phase)     = U[j] * P[i] - V[j] * Q[i]
    U = cos(gx w0), V = sin(gx w0), P = cos(gy w1 + c), Q = sin(gy w1 + c)

U, V, P, Q (B, n, F) are built here in plain torch (pose_tables); the kernel
(csrc/decoder_pose.cu) rebuilds each pixel tile's features bf16(U P - V Q)
on chip and runs W1 (+ b1 + hz) -> act -> (L-1) x (H -> H, act) -> W3, with
every h rounded to bf16 before the next matmul and f32 accumulation. The
(pixels, F) feature matrix never reaches device memory.
"""

from __future__ import annotations

import torch

from . import _build

LEAKY_SLOPE = 0.01
ACT_CODES = {"leakyrelu": 0, "tanh": 1}


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The kernels' shared activation (targetvae_tpu/kernels/decoder_mlp.py)."""
    if kind == "tanh":
        return torch.tanh(h)
    return torch.where(h >= 0, h, LEAKY_SLOPE * h)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bf16 value and return it as float32 — the
    plain versions' stand-in for a bf16 matmul operand with f32 accumulation."""
    return x.to(torch.bfloat16).float()


def pose_decoder_supported(cfg) -> bool:
    """Needs the Fourier expansion (separable phase), >= 2 layers, no resid
    skips and a latent."""
    return (cfg.fourier_expansion and cfg.num_layers >= 2 and not cfg.resid
            and cfg.z_dim > 0)


def pose_freqs(theta, dx, wf_over_sigma, bf):
    """Per-image rotated frequencies (B, F): w0, w1 = rows of R(theta) @ wf,
    and the phase constant cvec = bf - dx @ w''."""
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    w0 = c * wf_over_sigma[0] + s * wf_over_sigma[1]
    w1 = -s * wf_over_sigma[0] + c * wf_over_sigma[1]
    cvec = bf[None] - (dx[:, 0:1] * w0 + dx[:, 1:2] * w1)
    return w0, w1, cvec


def pose_tables(theta, dx, wf_over_sigma, bf, image_dim: int):
    """U, V, P, Q (B, n, F) float32; gx = linspace(-1, 1), gy = linspace(1, -1)."""
    n = image_dim
    w0, w1, cvec = pose_freqs(theta, dx, wf_over_sigma, bf)
    gx = torch.linspace(-1.0, 1.0, n, device=theta.device)
    gy = torch.linspace(1.0, -1.0, n, device=theta.device)
    ax = gx[None, :, None] * w0[:, None, :]
    ay = gy[None, :, None] * w1[:, None, :] + cvec[:, None, :]
    return torch.cos(ax), torch.sin(ax), torch.cos(ay), torch.sin(ay)


def pose_decoder_plain(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, *,
                       act_kind: str = "leakyrelu") -> torch.Tensor:
    """Plain PyTorch version (materialises the (B, n*n, F) features).
    wh (L-1, H, H), bh (L-1, H). Returns (B, n*n, n_out) float32."""
    b, n, f = u.shape
    feat = (u[:, None] * p[:, :, None] - v[:, None] * q[:, :, None])
    feat = bf16_round(feat.reshape(b, n * n, f))
    h = bf16_round(_act(feat @ bf16_round(w1.float()) + b1.float()
                        + hz.float()[:, None, :], act_kind))
    for l in range(wh.shape[0]):
        h = bf16_round(_act(h @ bf16_round(wh[l].float()) + bh[l].float(),
                            act_kind))
    return h @ bf16_round(w3.float()) + b3.float()


def fused_pose_decoder_tables(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, *,
                              act_kind: str = "leakyrelu") -> torch.Tensor:
    """u, v, p, q (B, n, F) f32; hz (B, H) f32; w1 (F, H); b1 (H,);
    wh (L-1, H, H); bh (L-1, H); w3 (H, n_out); b3 (n_out,).
    Returns (B, n*n, n_out) float32. A CPU u takes the plain version; a CUDA
    one launches csrc/decoder_pose.cu."""
    if u.device.type == "cpu":
        return pose_decoder_plain(u, v, p, q, hz, w1, b1, wh, bh, w3, b3,
                                  act_kind=act_kind)
    b, n, f = u.shape
    hdim = w1.shape[1]
    n_hidden = wh.shape[0]
    n_out = w3.shape[1]
    if hdim not in (64, 128, 256, 512) or f % 32:
        raise ValueError(f"pose decoder kernel needs hidden in (64, 128, 256, "
                         f"512) and F % 32 == 0, got hidden={hdim} F={f}")
    if n_hidden < 1 or n_out > 8:
        raise ValueError(f"pose decoder kernel needs >= 2 layers and n_out <= 8")
    bf, f32 = torch.bfloat16, torch.float32
    c = lambda t, dt: t.to(dt).contiguous()
    args = (c(u, f32), c(v, f32), c(p, f32), c(q, f32), c(hz, f32),
            c(w1, bf), c(b1, f32), c(wh, bf), c(bh, f32), c(w3, bf), c(b3, f32))
    _build.check_cuda(*args, dtypes=(f32,) * 5 + (bf, f32, bf, f32, bf, f32))
    for t, shape in ((args[1], (b, n, f)), (args[2], (b, n, f)),
                     (args[3], (b, n, f)), (args[4], (b, hdim)),
                     (args[5], (f, hdim)), (args[7], (n_hidden, hdim, hdim)),
                     (args[8], (n_hidden, hdim)), (args[9], (hdim, n_out))):
        if tuple(t.shape) != shape:
            raise ValueError(f"expected {shape}, got {tuple(t.shape)}")
    y = torch.empty((b, n * n, n_out), dtype=f32, device=u.device)
    if b:
        _build.launch("tvae_pose_decoder_fwd", *(t.data_ptr() for t in args),
                      y.data_ptr(), b, n, f, hdim, n_hidden + 1, n_out,
                      ACT_CODES[act_kind],
                      torch.cuda.current_stream(u.device).cuda_stream)
        fused_pose_decoder_tables.launches += 1
    return y


fused_pose_decoder_tables.launches = 0


def fused_pose_decoder(theta, dx, z, params: dict, cfg,
                       image_dim: int) -> torch.Tensor:
    """(theta (B,), dx (B, 2), z (B, zd)) -> (B, image_dim^2, n_out); equal to
    generator_apply(params, cfg, transform_coords(grid, dx, theta), z) up to
    the bf16 rounding of the matmul operands."""
    wf = params["fourier"]["w"].detach() / cfg.fourier_sigma
    bf = params["fourier"]["b"].detach()
    u, v, p, q = pose_tables(theta, dx, wf, bf, image_dim)
    hz = z @ params["latent_linear"]["w"]
    hidden = params["hidden"]
    wh = torch.stack([h["w"] for h in hidden])
    bh = torch.stack([h["b"] for h in hidden])
    return fused_pose_decoder_tables(
        u, v, p, q, hz, params["coord_linear"]["w"], params["coord_linear"]["b"],
        wh, bh, params["out"]["w"], params["out"]["b"], act_kind=cfg.activation)
