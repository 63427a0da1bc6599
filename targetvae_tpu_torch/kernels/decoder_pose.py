"""Pose-aware fused decoder (K7 forward, K8 backward): separable Fourier phase.

Port of targetvae_tpu/kernels/decoder_pose.py::fused_pose_decoder (its `_fwd`,
`_bwd` and `_vjp_bwd`). The decoder's coordinates are an affine transform of
the regular pixel grid, x = (x0 - dx) @ R(theta) with x0[i, j] = (gx[j],
gy[i]), so the Fourier phase is separable:

    phase[i, j, f] = gx[j] * w0[f] + gy[i] * w1[f] + c[f]
    w'' = R(theta) @ (Wf / sigma) (per image),  c = bf - dx @ w''
    cos(phase)     = U[j] * P[i] - V[j] * Q[i]
    U = cos(gx w0), V = sin(gx w0), P = cos(gy w1 + c), Q = sin(gy w1 + c)

U, V, P, Q (B, n, F) are built here in plain torch (pose_tables); the kernel
(csrc/decoder_pose.cu) rebuilds each pixel tile's features bf16(U P - V Q)
on chip and runs W1 (+ b1 + hz) -> act -> (L-1) x (H -> H, act) -> W3, with
every h rounded to bf16 before the next matmul and f32 accumulation, on
wgmma (csrc/decoder_wgmma.cuh). The (pixels, F) feature matrix never reaches
device memory.

For training, the forward runs in its save-residuals mode and also writes the
L bf16 h tiles (one after coord_linear, one after each hidden layer); the
backward (K8, csrc/decoder_pose_bwd.cu) consumes them, returns the weight
gradients, dhz, and the pose cotangents reduced to three (B, F) vectors,
which pose_closure turns into dtheta and d(dx). _PoseDecoder joins the two
as one autograd Function; the Fourier w and b get no gradient.
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


def _dact(pre: torch.Tensor, kind: str) -> torch.Tensor:
    """The activation's derivative from its f32 input (targetvae_tpu/kernels/
    decoder_mlp.py::_dact): tanh' = 1 - tanh(pre)^2, leaky by the sign."""
    if kind == "tanh":
        t = torch.tanh(pre)
        return 1.0 - t * t
    return torch.where(pre >= 0, 1.0, LEAKY_SLOPE)


def _dact_from_h(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The activation's derivative recovered from its (bf16) value h
    (targetvae_tpu/kernels/decoder_mlp.py): leaky keeps the sign of its
    input, tanh' = 1 - h^2."""
    h = h.float()
    if kind == "tanh":
        return 1.0 - h * h
    return torch.where(h >= 0, 1.0, LEAKY_SLOPE)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bf16 value and return it as float32 — the
    plain versions' stand-in for a bf16 matmul operand with f32 accumulation."""
    return x.to(torch.bfloat16).float()


# the hidden widths the wgmma decoder kernels (K7-K10) take
KERNEL_HIDDEN = (64, 128, 256, 512)


def pose_decoder_supported(cfg, grad: bool = False) -> bool:
    """Whether K7 (and, with `grad`, its backward K8) takes this generator
    config: the Fourier expansion (separable phase), >= 2 layers, no resid
    skips, a latent, hidden in KERNEL_HIDDEN, n_out <= 8 and F % 32 == 0
    (K8: F % 64 == 0), the launchers' own rules. The bf16 tier runs the
    XLA bf16 recipe (transform_coords, then generator_apply) otherwise;
    the route is chosen from the config before any launch."""
    return (cfg.fourier_expansion and cfg.num_layers >= 2 and not cfg.resid
            and cfg.z_dim > 0 and cfg.hidden_dim in KERNEL_HIDDEN
            and cfg.n_out <= 8 and cfg.embedding_dim % (64 if grad else 32) == 0)


def pose_freqs(theta, dx, wf_over_sigma, bf):
    """Per-image rotated frequencies (B, F): w0, w1 = rows of R(theta) @ wf,
    and the phase constant cvec = bf - dx @ w''."""
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    w0 = c * wf_over_sigma[0] + s * wf_over_sigma[1]
    w1 = -s * wf_over_sigma[0] + c * wf_over_sigma[1]
    cvec = bf[None] - (dx[:, 0:1] * w0 + dx[:, 1:2] * w1)
    return w0, w1, cvec


def _pixel_grid(n: int, device):
    """The pixel coordinates gx = linspace(-1, 1), gy = linspace(1, -1), (n,)
    each, that the forward's tables and the backward's pose sums share."""
    return (torch.linspace(-1.0, 1.0, n, device=device),
            torch.linspace(1.0, -1.0, n, device=device))


def pose_tables(theta, dx, wf_over_sigma, bf, image_dim: int):
    """U, V, P, Q (B, n, F) float32 over the pixel grid of _pixel_grid."""
    w0, w1, cvec = pose_freqs(theta, dx, wf_over_sigma, bf)
    gx, gy = _pixel_grid(image_dim, theta.device)
    ax = gx[None, :, None] * w0[:, None, :]
    ay = gy[None, :, None] * w1[:, None, :] + cvec[:, None, :]
    return torch.cos(ax), torch.sin(ax), torch.cos(ay), torch.sin(ay)


def pose_features(u, v, p, q):
    """The (B, n*n, F) features bf16(U[j] P[i] - V[j] Q[i]), as float32."""
    b, n, f = u.shape
    feat = (u[:, None] * p[:, :, None] - v[:, None] * q[:, :, None])
    return bf16_round(feat.reshape(b, n * n, f))


def pose_decoder_plain(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, *,
                       act_kind: str = "leakyrelu", save_res: bool = False):
    """Plain PyTorch version (materialises the (B, n*n, F) features).
    wh (L-1, H, H), bh (L-1, H). Returns (B, n*n, n_out) float32, and with
    save_res also the bf16 h tiles (L, B, n*n, H)."""
    return mlp_chain_plain(pose_features(u, v, p, q), hz, w1, b1, wh, bh, w3,
                           b3, act_kind=act_kind, save_res=save_res)


def mlp_chain_plain(feat, hz, w1, b1, wh, bh, w3, b3, *,
                    act_kind: str = "leakyrelu", save_res: bool = False):
    """The decoder's chain after its bf16-valued features feat (B, P, F),
    with the kernels' rounding points (K7's and K9's plain versions)."""
    h = bf16_round(_act(feat @ bf16_round(w1.float()) + b1.float()
                        + hz.float()[:, None, :], act_kind))
    hs = [h]
    for l in range(wh.shape[0]):
        h = bf16_round(_act(h @ bf16_round(wh[l].float()) + bh[l].float(),
                            act_kind))
        hs.append(h)
    y = h @ bf16_round(w3.float()) + b3.float()
    if save_res:
        return y, torch.stack(hs).to(torch.bfloat16)
    return y


def fused_pose_decoder_tables(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, *,
                              act_kind: str = "leakyrelu",
                              save_res: bool = False):
    """u, v, p, q (B, n, F) f32; hz (B, H) f32; w1 (F, H); b1 (H,);
    wh (L-1, H, H); bh (L-1, H); w3 (H, n_out); b3 (n_out,).
    Returns (B, n*n, n_out) float32; with save_res (training) also the bf16
    h tiles (L, B, n*n, H) that the backward consumes. A CPU u takes the
    plain version; a CUDA one launches csrc/decoder_pose.cu."""
    if u.device.type == "cpu":
        return pose_decoder_plain(u, v, p, q, hz, w1, b1, wh, bh, w3, b3,
                                  act_kind=act_kind, save_res=save_res)
    b, n, f = u.shape
    hdim = w1.shape[1]
    n_hidden = wh.shape[0]
    n_out = w3.shape[1]
    if hdim not in KERNEL_HIDDEN or f % 32:
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
    hs = (torch.empty((n_hidden + 1, b, n * n, hdim), dtype=bf, device=u.device)
          if save_res else None)
    if b:
        _build.launch("tvae_pose_decoder_fwd", *(t.data_ptr() for t in args),
                      y.data_ptr(), None if hs is None else hs.data_ptr(),
                      b, n, f, hdim, n_hidden + 1, n_out, ACT_CODES[act_kind],
                      torch.cuda.current_stream(u.device).cuda_stream)
        fused_pose_decoder_tables.launches += 1
    return (y, hs) if save_res else y


fused_pose_decoder_tables.launches = 0


def pose_decoder_bwd_plain(u, v, p, q, hs, w1, wh, w3, g, *,
                           act_kind: str = "leakyrelu"):
    """Plain PyTorch version of the backward, with the kernel's rounding
    points. hs (L, B, n*n, H) bf16 from the forward; g (B, n*n, n_out).
    Returns dfx, dfy, dfc (B, F), dhz (B, H), dw1 (F, H), db1 (H,),
    dwh (L-1, H, H), dbh (L-1, H), dw3 (H, n_out), db3 (n_out,)."""
    b, n, f = u.shape
    dpre1, dwh, dbh, dw3, db3 = mlp_chain_bwd_plain(hs, wh, w3, g,
                                                    act_kind=act_kind)
    dpre1_16 = bf16_round(dpre1)
    dhz = dpre1.sum(1)
    dw1 = torch.einsum("bpf,bph->fh", pose_features(u, v, p, q), dpre1_16)
    s = (v[:, None] * p[:, :, None] + u[:, None] * q[:, :, None]).reshape(
        b, n * n, f)
    t = (dpre1_16 @ bf16_round(w1.float()).T) * s
    del s
    gx, gy = _pixel_grid(n, u.device)
    wx = gx.repeat(n)[None, :, None]                # pixel i*n + j -> gx[j]
    wy = gy.repeat_interleave(n)[None, :, None]     # -> gy[i]
    return (-(t * wx).sum(1), -(t * wy).sum(1), -t.sum(1), dhz, dw1,
            dhz.sum(0), dwh, dbh, dw3, db3)


def mlp_chain_bwd_plain(hs, wh, w3, g, *, act_kind: str = "leakyrelu"):
    """The chain pass of K8 and K10 with their rounding points: from g
    (B, P, n_out) and the bf16 h tiles hs (L, B, P, H) down to the f32
    dpre1 (B, P, H). Returns dpre1, dwh (L-1, H, H), dbh (L-1, H),
    dw3 (H, n_out), db3 (n_out,)."""
    L = hs.shape[0]
    hsf = hs.float()
    g = g.float()
    g16 = bf16_round(g)
    db3 = g.sum((0, 1))
    dw3 = torch.einsum("bph,bpc->hc", hsf[L - 1], g16)
    dh = g16 @ bf16_round(w3.float()).T
    dwh, dbh = [None] * (L - 1), [None] * (L - 1)
    for l in range(L - 1, 0, -1):
        dpre = dh * _dact_from_h(hsf[l], act_kind)
        dpre16 = bf16_round(dpre)
        dwh[l - 1] = torch.einsum("bph,bpk->hk", hsf[l - 1], dpre16)
        dbh[l - 1] = dpre.sum((0, 1))
        dh = dpre16 @ bf16_round(wh[l - 1].float()).T
    dpre1 = dh * _dact_from_h(hsf[0], act_kind)
    return dpre1, torch.stack(dwh), torch.stack(dbh), dw3, db3


TILE_PX = 64      # pixel rows of a tile of the wgmma kernels (wgmma's M)


def wgrad_schedule(rows: int, m: int, n: int, sms: int,
                   rebuilt: bool = False):
    """Grid of K8's and K10's split-K weight-gradient product of an (m, n)
    output over `rows` pixel rows (csrc/decoder_wgmma.cuh::launch_wgrad):
    output tiles of 64 x 512 where the A operand is rebuilt features and
    n % 512 == 0 (each feature built once for all 512 columns), else
    128 x 256, 128 x 128 or 128 x 64, the widest that divides n (a multiple
    of 64), rows past m masked; and as many pixel splits as fill `sms` SMs
    in one wave with the tiles. Returns (grid (x, y, splits), (tile
    rows, tile columns), chunk): split z covers pixel rows
    [z * chunk, min(rows, (z + 1) * chunk)), chunk a multiple of TILE_PX,
    and every split holds at least one row."""
    tm, tn = ((64, 512) if rebuilt and n % 512 == 0 else
              (128, next(w for w in (256, 128, 64) if n % w == 0)))
    gx, gy = -(-m // tm), n // tn
    s = max(1, sms // (gx * gy))
    chunk = -(-(-(-rows // s)) // TILE_PX) * TILE_PX
    return (gx, gy, -(-rows // chunk)), (tm, tn), chunk


def pose_decoder_bwd(u, v, p, q, hs, w1, wh, w3, g, *,
                     act_kind: str = "leakyrelu"):
    """The backward of fused_pose_decoder_tables (K8), with the outputs of
    pose_decoder_bwd_plain. A CPU u takes the plain version; a CUDA one
    launches csrc/decoder_pose_bwd.cu (its passes run on the current
    stream)."""
    if u.device.type == "cpu":
        return pose_decoder_bwd_plain(u, v, p, q, hs, w1, wh, w3, g,
                                      act_kind=act_kind)
    b, n, f = u.shape
    L, _, npx, hdim = hs.shape
    n_out = w3.shape[1]
    if (hdim not in KERNEL_HIDDEN or f % 64 or n_out > 8 or L < 2
            or npx != n * n):
        raise ValueError(f"pose decoder backward kernel needs hidden in (64, "
                         f"128, 256, 512), F % 64 == 0, n_out <= 8 and >= 2 "
                         f"layers, got hidden={hdim} F={f} n_out={n_out} "
                         f"layers={L}")
    bf, f32 = torch.bfloat16, torch.float32
    c = lambda t, dt: t.to(dt).contiguous()
    gx, gy = _pixel_grid(n, u.device)
    args = (c(u, f32), c(v, f32), c(p, f32), c(q, f32), c(w1, bf), c(wh, bf),
            c(w3, bf), c(g, f32), c(hs, bf), gx, gy)
    _build.check_cuda(*args, dtypes=(f32,) * 4 + (bf,) * 3 + (f32, bf, f32, f32))
    for t, shape in ((args[1], (b, n, f)), (args[2], (b, n, f)),
                     (args[3], (b, n, f)), (args[4], (f, hdim)),
                     (args[5], (L - 1, hdim, hdim)), (args[6], (hdim, n_out)),
                     (args[7], (b, npx, n_out))):
        if tuple(t.shape) != shape:
            raise ValueError(f"expected {shape}, got {tuple(t.shape)}")
    dev = u.device
    x = L * hdim + hdim * n_out + n_out
    ntiles = -(-npx // TILE_PX)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    (_, _, s1), _, c1 = wgrad_schedule(b * npx, f, hdim, sms, rebuilt=True)
    (_, _, s2), _, c2 = wgrad_schedule(b * npx, hdim, hdim, sms)
    e = lambda *shape, dt=f32: torch.empty(shape, dtype=dt, device=dev)
    dP = e(L, b, npx, hdim, dt=bf)
    part, cols_img, cols = e(b * ntiles, x), e(b, x), e(x)
    gpart = e(max(s1 * f * hdim, s2 * hdim * hdim))
    dpart, df = e(b * ntiles, 3, f), e(b, 3, f)
    dw1, dwh = e(f, hdim), e(L - 1, hdim, hdim)
    if b:
        _build.launch("tvae_pose_decoder_bwd", *(t.data_ptr() for t in args),
                      *(t.data_ptr() for t in (dP, part, cols_img, cols, gpart,
                                               dpart, df, dw1, dwh)),
                      b, n, f, hdim, L, n_out, s1, c1, s2, c2,
                      ACT_CODES[act_kind],
                      torch.cuda.current_stream(dev).cuda_stream)
        pose_decoder_bwd.launches += 1
    h = hdim
    return (df[:, 0], df[:, 1], df[:, 2], cols_img[:, :h], dw1, cols[:h], dwh,
            cols[h:L * h].reshape(L - 1, h),
            cols[L * h:L * h + h * n_out].reshape(h, n_out),
            cols[L * h + h * n_out:])


pose_decoder_bwd.launches = 0


def pose_closure(theta, dx, wf_over_sigma, bf, dfx, dfy, dfc):
    """dtheta (B,) and d(dx) (B, 2) from the backward's frequency cotangents
    (targetvae_tpu/kernels/decoder_pose.py::_vjp_bwd), O(B*F) work."""
    a0, a1, _ = pose_freqs(theta, dx, wf_over_sigma, bf)
    ddx = -torch.stack([(dfc * a0).sum(1), (dfc * a1).sum(1)], dim=1)
    a0_tot = dfx - dfc * dx[:, 0:1]
    a1_tot = dfy - dfc * dx[:, 1:2]
    return (a0_tot * a1 - a1_tot * a0).sum(1), ddx


class _PoseDecoder(torch.autograd.Function):
    """K7 in its save-residuals mode, with K8 and pose_closure as its
    backward. Gradients for theta, dx, hz and every weight; none for the
    Fourier w and b."""

    @staticmethod
    def forward(ctx, theta, dx, wf, bf, hz, w1, b1, wh, bh, w3, b3,
                image_dim, act_kind):
        u, v, p, q = pose_tables(theta, dx, wf, bf, image_dim)
        y, hs = fused_pose_decoder_tables(u, v, p, q, hz, w1, b1, wh, bh, w3,
                                          b3, act_kind=act_kind, save_res=True)
        ctx.save_for_backward(theta, dx, wf, bf, u, v, p, q, hs, w1, wh, w3)
        ctx.act_kind = act_kind
        return y

    @staticmethod
    def backward(ctx, g):
        theta, dx, wf, bf, u, v, p, q, hs, w1, wh, w3 = ctx.saved_tensors
        (dfx, dfy, dfc, dhz, dw1, db1, dwh, dbh, dw3, db3) = pose_decoder_bwd(
            u, v, p, q, hs, w1, wh, w3, g, act_kind=ctx.act_kind)
        dtheta, ddx = pose_closure(theta, dx, wf, bf, dfx, dfy, dfc)
        return (dtheta, ddx, None, None, dhz, dw1, db1, dwh, dbh, dw3, db3,
                None, None)


def fused_pose_decoder(theta, dx, z, params: dict, cfg,
                       image_dim: int) -> torch.Tensor:
    """(theta (B,), dx (B, 2), z (B, zd)) -> (B, image_dim^2, n_out); equal to
    generator_apply(params, cfg, transform_coords(grid, dx, theta), z) up to
    the bf16 rounding of the matmul operands. Differentiable in theta, dx, z
    and every weight but the Fourier buffers."""
    wf = params["fourier"]["w"].detach() / cfg.fourier_sigma
    bf = params["fourier"]["b"].detach()
    hz = z @ params["latent_linear"]["w"]
    hidden = params["hidden"]
    wh = torch.stack([h["w"] for h in hidden])
    bh = torch.stack([h["b"] for h in hidden])
    w1, b1 = params["coord_linear"]["w"], params["coord_linear"]["b"]
    w3, b3 = params["out"]["w"], params["out"]["b"]
    # only training pays for the saved h tiles: serving runs K7 alone
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (theta, dx, hz, w1, b1, wh, bh, w3, b3)):
        return _PoseDecoder.apply(theta, dx, wf, bf, hz, w1, b1, wh, bh, w3,
                                  b3, image_dim, cfg.activation)
    u, v, p, q = pose_tables(theta, dx, wf, bf, image_dim)
    return fused_pose_decoder_tables(u, v, p, q, hz, w1, b1, wh, bh, w3, b3,
                                     act_kind=cfg.activation)
