"""Fused decoder at arbitrary coordinates: forward (K9) and backward (K10).

Port of targetvae_tpu/kernels/decoder_mlp.py::fused_decoder_mlp (its `_fwd`
and `_bwd`), the kernel behind the bf16 generator_apply / TargetVAE.decode.
For every pixel of every image, with x the per-image coordinates:

    f = bf16(cos(x0 wf[0] + x1 wf[1] + bf))      (phase in float32)
    h = bf16(act(f @ W1 + b1 + hz)); h = bf16(act(h @ Wh[l] + bh[l]))
    y = h @ W3 + b3                             (f32 accumulation)

wf is the Fourier weight already divided by sigma; wf and bf are buffers
and get no gradient. The kernels are csrc/decoder_mlp.cu, the pose
decoder's wgmma kernels (csrc/decoder_wgmma.cuh) with the FEAT_COORD
feature source; the plain versions below round at the same points. Like
the TPU kernel the backward saves nothing and recomputes the forward;
_DecoderMLP joins the two as one autograd Function with gradients for x, hz
and every weight.
"""

from __future__ import annotations

import torch

from . import _build
from .decoder_pose import (ACT_CODES, KERNEL_HIDDEN, TILE_PX, bf16_round,
                           mlp_chain_bwd_plain, mlp_chain_plain,
                           wgrad_schedule)


def decoder_kernel_supported(cfg, grad: bool = False) -> bool:
    """Whether K9 (and, with `grad`, its backward K10) takes this generator
    config: the JAX package's configurations (the Fourier expansion, 2
    layers, no resid skips, a latent) at the widths the launchers take:
    hidden in KERNEL_HIDDEN, F % 64 == 0 and, for K10, n_out <= 8 (K9
    forms the heads 16 at a time, any n_out). generator_apply runs the XLA
    bf16 recipe otherwise; the route is chosen from the config before any
    launch."""
    return (cfg.fourier_expansion and cfg.num_layers == 2 and not cfg.resid
            and cfg.z_dim > 0 and cfg.hidden_dim in KERNEL_HIDDEN
            and cfg.embedding_dim % 64 == 0 and (not grad or cfg.n_out <= 8))


def _phase(x, wf, bf):
    """(B, P, F) phase x0 wf[0] + x1 wf[1] + bf in float32, in the kernels'
    order of operations."""
    return x[..., 0:1] * wf[0] + x[..., 1:2] * wf[1] + bf


def decoder_mlp_plain(x, wf, bf, hz, w1, b1, wh, bh, w3, b3, *,
                      act_kind: str = "leakyrelu", save_res: bool = False):
    """Plain PyTorch version of K9 (materialises the (B, P, F) features).
    Returns (B, P, n_out) float32, with save_res also the bf16 h tiles
    (L, B, P, H)."""
    feat = bf16_round(torch.cos(_phase(x.float(), wf.float(), bf.float())))
    return mlp_chain_plain(feat, hz, w1, b1, wh, bh, w3, b3,
                           act_kind=act_kind, save_res=save_res)


def _check_shapes(x, wf, hz, w1, wh, bh, w3):
    b, npx = x.shape[:2]
    f, hdim = w1.shape
    for t, shape in ((x, (b, npx, 2)), (wf, (2, f)), (hz, (b, hdim)),
                     (wh, (wh.shape[0], hdim, hdim)), (bh, (wh.shape[0], hdim)),
                     (w3, (hdim, w3.shape[1]))):
        if tuple(t.shape) != shape:
            raise ValueError(f"expected {shape}, got {tuple(t.shape)}")
    if hdim not in KERNEL_HIDDEN or f % 64 or wh.shape[0] < 1:
        raise ValueError(f"decoder_mlp kernel needs hidden in (64, 128, 256, "
                         f"512), F % 64 == 0 and >= 2 layers, got hidden="
                         f"{hdim} F={f} layers={wh.shape[0] + 1}")


def _cuda_args(x, wf, bf, hz, w1, b1, wh, bh, w3, b3):
    """The kernels' arguments, with wmax = (max |wf[0]|, max |wf[1]|,
    max |bf|) after bf: the kernels bound each tile's phases by it, so that
    a tile whose phases all lie in their straight-line cosine's range
    carries no check."""
    bf16, f32 = torch.bfloat16, torch.float32
    c = lambda t, dt: t.to(dt).contiguous()
    wf, bf = c(wf, f32), c(bf, f32)
    wmax = torch.cat([wf.abs().amax(1), bf.abs().amax()[None]])
    args = (c(x, f32), wf, bf, wmax, c(hz, f32), c(w1, bf16), c(b1, f32),
            c(wh, bf16), c(bh, f32), c(w3, bf16), c(b3, f32))
    _build.check_cuda(*args, dtypes=(f32,) * 5 + (bf16, f32) * 3)
    return args


def decoder_mlp_fwd(x, wf, bf, hz, w1, b1, wh, bh, w3, b3, *,
                    act_kind: str = "leakyrelu", save_res: bool = False):
    """x (B, P, 2) f32; wf (2, F) divided by sigma; bf (F,); hz (B, H) f32;
    w1 (F, H); b1 (H,); wh (L-1, H, H); bh (L-1, H); w3 (H, n_out);
    b3 (n_out,). Returns (B, P, n_out) float32, with save_res also the bf16
    h tiles (L, B, P, H), as the pose decoder's wrapper. Any n_out: the
    kernel forms the heads 16 at a time. A CPU x takes the plain version;
    a CUDA one launches csrc/decoder_mlp.cu."""
    if x.device.type == "cpu":
        return decoder_mlp_plain(x, wf, bf, hz, w1, b1, wh, bh, w3, b3,
                                 act_kind=act_kind, save_res=save_res)
    _check_shapes(x, wf, hz, w1, wh, bh, w3)
    args = _cuda_args(x, wf, bf, hz, w1, b1, wh, bh, w3, b3)
    b, npx, _ = x.shape
    f, hdim = w1.shape
    L, n_out = wh.shape[0] + 1, w3.shape[1]
    y = torch.empty((b, npx, n_out), dtype=torch.float32, device=x.device)
    hs = (torch.empty((L, b, npx, hdim), dtype=torch.bfloat16, device=x.device)
          if save_res else None)
    if b and npx:
        _build.launch("tvae_decoder_mlp_fwd", *(t.data_ptr() for t in args),
                      y.data_ptr(), None if hs is None else hs.data_ptr(),
                      b, npx, f, hdim, L, n_out, ACT_CODES[act_kind],
                      torch.cuda.current_stream(x.device).cuda_stream)
        decoder_mlp_fwd.launches += 1
    return (y, hs) if save_res else y


decoder_mlp_fwd.launches = 0


def decoder_mlp_bwd_plain(x, wf, bf, hz, w1, b1, wh, bh, w3, b3, g, *,
                          act_kind: str = "leakyrelu"):
    """Plain PyTorch version of K10, with its rounding points: recomputes
    the forward, then K8's chain. g (B, P, n_out). Returns dx (B, P, 2),
    dhz (B, H), dw1 (F, H), db1 (H,), dwh (L-1, H, H), dbh (L-1, H),
    dw3 (H, n_out), db3 (n_out,), all float32."""
    phase = _phase(x.float(), wf.float(), bf.float())
    feat = bf16_round(torch.cos(phase))
    _, hs = mlp_chain_plain(feat, hz, w1, b1, wh, bh, w3, b3,
                            act_kind=act_kind, save_res=True)
    dpre1, dwh, dbh, dw3, db3 = mlp_chain_bwd_plain(hs, wh, w3, g,
                                                    act_kind=act_kind)
    dpre1_16 = bf16_round(dpre1)
    dhz = dpre1.sum(1)
    dw1 = torch.einsum("bpf,bph->fh", feat, dpre1_16)
    del feat
    darg = -torch.sin(phase) * (dpre1_16 @ bf16_round(w1.float()).T)
    dx = torch.stack([(darg * wf[0]).sum(-1), (darg * wf[1]).sum(-1)], -1)
    return dx, dhz, dw1, dhz.sum(0), dwh, dbh, dw3, db3


def decoder_mlp_bwd(x, wf, bf, hz, w1, b1, wh, bh, w3, b3, g, *,
                    act_kind: str = "leakyrelu"):
    """The backward of decoder_mlp_fwd (K10), with the outputs of
    decoder_mlp_bwd_plain. A CPU x takes the plain version; a CUDA one
    launches csrc/decoder_mlp.cu (its passes run on the current stream)."""
    if x.device.type == "cpu":
        return decoder_mlp_bwd_plain(x, wf, bf, hz, w1, b1, wh, bh, w3, b3, g,
                                     act_kind=act_kind)
    _check_shapes(x, wf, hz, w1, wh, bh, w3)
    b, npx, _ = x.shape
    f, h = w1.shape
    L, n_out = wh.shape[0] + 1, w3.shape[1]
    if n_out > 8 or tuple(g.shape) != (b, npx, n_out):
        raise ValueError(f"decoder_mlp backward kernel needs n_out <= 8 and g "
                         f"of {(b, npx, n_out)}, got {tuple(g.shape)}")
    args = _cuda_args(x, wf, bf, hz, w1, b1, wh, bh, w3, b3)
    gc = g.to(torch.float32).contiguous()
    _build.check_cuda(args[0], gc, dtypes=(torch.float32,) * 2)
    dev = x.device
    e = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                     device=dev)
    x_cols = L * h + h * n_out + n_out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    (_, _, s1), _, c1 = wgrad_schedule(b * npx, f, h, sms, rebuilt=True)
    (_, _, s2), _, c2 = wgrad_schedule(b * npx, h, h, sms)
    y, hs, dP = e(b, npx, n_out), e(L, b, npx, h, dt=torch.bfloat16), e(
        L, b, npx, h, dt=torch.bfloat16)
    part, cols_img, cols = (e(b * -(-npx // TILE_PX), x_cols), e(b, x_cols),
                            e(x_cols))
    gpart = e(max(s1 * f * h, s2 * h * h))
    dx, dw1, dwh = e(b, npx, 2), e(f, h), e(L - 1, h, h)
    if b and npx:
        _build.launch("tvae_decoder_mlp_bwd", *(t.data_ptr() for t in args),
                      *(t.data_ptr() for t in (gc, y, hs, dP, part, cols_img,
                                               cols, gpart, dx, dw1, dwh)),
                      b, npx, f, h, L, n_out, s1, c1, s2, c2,
                      ACT_CODES[act_kind],
                      torch.cuda.current_stream(dev).cuda_stream)
        decoder_mlp_bwd.launches += 1
    return (dx, cols_img[:, :h], dw1, cols[:h], dwh,
            cols[h:L * h].reshape(L - 1, h),
            cols[L * h:L * h + h * n_out].reshape(h, n_out),
            cols[L * h + h * n_out:])


decoder_mlp_bwd.launches = 0


class _DecoderMLP(torch.autograd.Function):
    """K9 forward, K10 backward; keeps only the inputs (the backward
    recomputes the forward, as the TPU kernel does)."""

    @staticmethod
    def forward(ctx, x, wf, bf, hz, w1, b1, wh, bh, w3, b3, act_kind):
        ctx.save_for_backward(x, wf, bf, hz, w1, b1, wh, bh, w3, b3)
        ctx.act_kind = act_kind
        return decoder_mlp_fwd(x, wf, bf, hz, w1, b1, wh, bh, w3, b3,
                               act_kind=act_kind)

    @staticmethod
    def backward(ctx, g):
        x, wf, bf, hz, w1, b1, wh, bh, w3, b3 = ctx.saved_tensors
        dx, dhz, *dw = decoder_mlp_bwd(x, wf, bf, hz, w1, b1, wh, bh, w3, b3,
                                       g.contiguous(), act_kind=ctx.act_kind)
        return (dx, None, None, dhz, *dw, None)


def fused_decoder_mlp(x, z, params: dict, cfg) -> torch.Tensor:
    """(x (B, P, 2), z (B, zd)) -> (B, P, n_out): the bf16 generator_apply of
    a configuration decoder_kernel_supported covers, with hz = z W_latent in
    float32. Differentiable in x, z and every weight but the Fourier
    buffers."""
    wf = params["fourier"]["w"].detach() / cfg.fourier_sigma
    bf = params["fourier"]["b"].detach()
    hz = z @ params["latent_linear"]["w"]
    hidden = params["hidden"]
    wh = torch.stack([h["w"] for h in hidden])
    bh = torch.stack([h["b"] for h in hidden])
    w1, b1 = params["coord_linear"]["w"], params["coord_linear"]["b"]
    w3, b3 = params["out"]["w"], params["out"]["b"]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, hz, w1, b1, wh, bh, w3, b3)):
        return _DecoderMLP.apply(x, wf, bf, hz, w1, b1, wh, bh, w3, b3,
                                 cfg.activation)
    return decoder_mlp_fwd(x, wf, bf, hz, w1, b1, wh, bh, w3, b3,
                           act_kind=cfg.activation)
