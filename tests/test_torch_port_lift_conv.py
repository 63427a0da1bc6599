"""K13, the conv tier's lift forward (kernels/lift_conv.py): its plain
version against F.conv2d on bf16-rounded operands and the JAX package's
lifted_conv2d bf16 route, the shapes it takes, and its weight gradient
(_LiftConv) against autograd through the bf16 conv; plus kernel-against-
plain cases that need a CUDA device (they skip on a machine without one).

The CUDA cases need no JAX, so on a GPU machine without it they run as
    python -m pytest --noconftest tests/test_torch_port_lift_conv.py -k cuda
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import targetvae_tpu_torch.kernels as kernels
from targetvae_tpu_torch.kernels.lift_conv import (
    _LiftConv, lift_conv_fwd, lift_conv_plain, lift_conv_plan,
    lift_conv_supported, out_side)
from targetvae_tpu_torch.models import encoders
from targetvae_tpu_torch.ops.groupconv import lifted_weight

# (B, n, C, R, K, k, padding): the flagship (B = 3), mode B's image-sized
# lift at mnist-b-p8 (k = n, padding n // 2; K cut to 16), a C = 3 lift
# with an odd k (the galaxy's kind)
SHAPES = {"flagship": (3, 50, 1, 8, 128, 28, 8),
          "mode B k = n": (2, 50, 1, 8, 16, 50, 25),
          "C = 3, odd k": (2, 24, 3, 4, 16, 13, 4)}


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, so every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


def _inputs(B, n, C, R, K, k, seed=0, device="cpu"):
    """Images in [0, 1) and the group filter bank (K, C, 1, k, k) at the
    reference's init scale, drawn with numpy."""
    rng = np.random.default_rng(seed)
    y = rng.random((B, n, n, C), dtype=np.float32)
    bound = 1.0 / np.sqrt(C * k * k)
    w = rng.uniform(-bound, bound, (K, C, 1, k, k)).astype(np.float32)
    return (torch.from_numpy(y).to(device), torch.from_numpy(w).to(device))


def _old_conv_rows(w, y, padding):
    """The conv tier's lift before K13: one bf16 F.conv2d with
    channels_last operands, its output as rows, differentiable in w."""
    w = w.to(torch.bfloat16)
    x = y.detach().permute(0, 3, 1, 2).to(torch.bfloat16)
    pre1 = F.conv2d(x.contiguous(memory_format=torch.channels_last),
                    w.contiguous(memory_format=torch.channels_last),
                    padding=padding)
    b, c, hp, wp = pre1.shape
    return pre1.permute(0, 2, 3, 1).reshape(b * hp * wp, c).contiguous()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_is_the_f32_conv_of_bf16_operands(shape):
    """The plain version is F.conv2d in float32 on the bf16-rounded images
    and weight, rounded to bf16 once, laid out as (B H' W', R K) rows."""
    B, n, C, R, K, k, pad = SHAPES[shape]
    y, w5 = _inputs(B, n, C, R, K, k)
    w = lifted_weight(w5, R).to(torch.bfloat16)
    got = lift_conv_plain(y, w, pad)
    x = y.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    ref = F.conv2d(x, w.float(), padding=pad)
    hp = out_side(n, k, pad)
    assert ref.shape == (B, R * K, hp, hp)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.permute(0, 2, 3, 1).reshape(-1, R * K)
                       .to(torch.bfloat16))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_lifted_conv2d_bf16(shape):
    """Against the JAX package's lifted_conv2d at compute_dtype bf16 (the
    XLA conv the JAX tier runs, its output rounded to bf16): the same
    elements but for a few that XLA's CPU convolution rounds otherwise
    (its own order of the partial sums): under 0.1 % of them (0.016-0.017 %
    here), each by at most one bf16 step at the largest element's size
    (2^-8 of it)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from targetvae_tpu.ops.groupconv import lifted_conv2d
    B, n, C, R, K, k, pad = SHAPES[shape]
    y, w5 = _inputs(B, n, C, R, K, k, seed=1)
    w = lifted_weight(w5, R).to(torch.bfloat16)
    got = lift_conv_plain(y, w, pad).float().numpy()
    ref = np.asarray(lifted_conv2d(jnp.asarray(y.numpy()),
                                   jnp.asarray(w5.numpy()), None, R,
                                   padding=pad, compute_dtype=jnp.bfloat16))
    hp = out_side(n, k, pad)
    assert ref.shape == (B, hp, hp, R, K)
    ref = ref.reshape(-1, R * K)
    assert np.abs(got - ref).max() <= 2.0 ** -8 * np.abs(ref).max()
    assert np.mean(got != ref) < 1e-3


# (y shape, w shape, padding, takes): the flagship, mnist-b-p8's
# image-sized lift, the conv tier at EMPIAR's k = 64, the galaxy (C = 3,
# k = 65), an N that is no multiple of 8 (padded to one), then image rows
# past shared memory: four channels at 128 x 128, mode B's image-sized
# lift at EMPIAR's 110 x 110 and on the galaxy's 64 x 64 x 3
SUPPORTED = [((100, 50, 50, 1), (1024, 1, 28, 28), 8, True),
             ((50, 50, 50, 1), (1024, 1, 28, 28), 8, True),
             ((100, 50, 50, 1), (1024, 1, 50, 50), 25, True),
             ((100, 110, 110, 1), (1024, 1, 64, 64), 16, True),
             ((100, 64, 64, 3), (1024, 3, 65, 65), 16, True),
             ((100, 50, 50, 1), (1020, 1, 28, 28), 8, True),
             ((100, 128, 128, 4), (1024, 4, 64, 64), 16, False),
             ((100, 110, 110, 1), (128, 1, 110, 110), 55, False),
             ((100, 64, 64, 3), (128, 3, 64, 64), 32, False)]


@pytest.mark.parametrize("y_shape, w_shape, padding, takes", SUPPORTED)
def test_lift_conv_supported_decides_from_the_shapes(y_shape, w_shape,
                                                     padding, takes):
    """lift_conv_supported from the shapes alone: the image rows a tile
    reads, the staging tiles and two stages of the weights' ring within a
    block's 227 KB, whatever N (padded to a multiple of 8); the flagship's
    layout keeps two image buffers and seven stages."""
    assert lift_conv_supported(y_shape, w_shape, padding) is takes
    B, H, W, C = y_shape
    plan = lift_conv_plan(B, H, W, C, w_shape[2], padding, w_shape[0])
    if takes:
        assert plan.smem <= 232448 and plan.stages >= 2
    if y_shape == (100, 50, 50, 1) and w_shape[2] == 28 and takes:
        assert (plan.rows, plan.nbuf, plan.stages, plan.items) == (
            62, 2, 7, 595 * 8)


@pytest.mark.parametrize("shape", SHAPES)
def test_lift_conv_weight_gradient_is_the_bf16_convs(shape):
    """On the CPU: conv_rows through _LiftConv gives the bf16 weight the
    gradient autograd gave it through the bf16 F.conv2d, bitwise, and the
    f32 filter bank (through the cast and the rotation gather) the same to
    1e-6 of its largest element (the gather's backward adds its terms in
    an order the CPU's threads set, run to run); the rows differ by one
    bf16 rounding at most; K13's launch counter stays 0 and no fallback is
    counted."""
    B, n, C, R, K, k, pad = SHAPES[shape]
    y, w5 = _inputs(B, n, C, R, K, k, seed=2)
    hp = out_side(n, k, pad)
    g = torch.randn(B * hp * hp, R * K,
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    out = []
    kernels.reset_launch_counts()
    for fn in (lambda w: encoders.conv_rows(w, y, pad)[0],
               lambda w: _old_conv_rows(w, y, pad)):
        p = w5.clone().requires_grad_(True)
        wb = lifted_weight(p, R).to(torch.bfloat16)
        wb.retain_grad()
        rows = fn(wb)
        rows.backward(g)
        out.append((rows.detach(), wb.grad, p.grad))
    counts = kernels.launch_counts()
    assert counts["lift_conv_fwd"] == 0 and counts["fallback.lift"] == 0
    (rows, gb, gp), (rows_ref, gb_ref, gp_ref) = out
    assert gb.dtype == torch.bfloat16 and torch.equal(gb, gb_ref)
    assert gp.dtype == torch.float32
    assert float((gp - gp_ref).abs().max()) <= 1e-6 * float(gp_ref.abs()
                                                            .max())
    diff = (rows.float() - rows_ref.float()).abs()
    assert float(diff.max()) <= 2.0 ** -8 * float(rows_ref.float().abs()
                                                  .max())


def test_conv_rows_counts_a_fallback_where_k13_does_not_take_the_shape():
    """Mode B's image-sized lift on the galaxy's 64 x 64 x 3 images (k =
    64, padding 32; 8 of its channels): the image rows a tile reads outgrow
    a block's shared memory, so conv_rows runs the bf16 F.conv2d it ran
    before K13, and counts fallback.lift once."""
    y, w5 = _inputs(1, 64, 3, 1, 8, 64)
    w = w5[:, :, 0]
    kernels.reset_launch_counts()
    rows, hp = encoders.conv_rows(w, y, 32)
    assert kernels.launch_counts()["fallback.lift"] == 1
    assert kernels.launch_counts()["lift_conv_fwd"] == 0
    assert hp == 65 and torch.equal(rows, _old_conv_rows(w, y, 32))
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["fallback.lift"] == 0


def test_conv_rows_takes_an_n_that_is_no_multiple_of_8():
    """N = 20: lift_conv_supported takes it (K13 pads the weight to 24
    channels and drops the padding from the rows), so conv_rows counts no
    fallback and gives the plain version's rows, (B H' W', 20) contiguous."""
    y, w5 = _inputs(2, 12, 1, 4, 5, 5)
    w = lifted_weight(w5, 4).to(torch.bfloat16)
    kernels.reset_launch_counts()
    rows, hp = encoders.conv_rows(w, y, 2)
    assert kernels.launch_counts()["fallback.lift"] == 0
    assert hp == 12 and rows.shape == (2 * 12 * 12, 20)
    assert rows.is_contiguous() and torch.equal(
        rows, lift_conv_plain(y, w, 2))


def test_lift_conv_function_takes_no_image_gradient():
    """_LiftConv's backward gives the weight its gradient and the images
    and the padding none."""
    y, w5 = _inputs(1, 10, 1, 4, 8, 4)
    w = lifted_weight(w5, 4).bfloat16().requires_grad_(True)
    yy = y.clone().requires_grad_(True)
    rows = _LiftConv.apply(w, yy, 1)
    rows.float().sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape
    assert yy.grad is None


# ---- on the card ----

# (B, n, C, R, K, k, padding) of the CUDA cases: the flagship at B = 100,
# its tail B = 50 and B = 1; mnist-b-p8's image-sized lift; the conv tier at
# EMPIAR's k = 64; the galaxy's C = 3, k = 65; then the edges of the
# layout: a tile over many small images with no padding, two channels and
# a channel slice of 40; an odd side with a slice of 96 (past one 64-channel
# store box); an odd k near the image's side; N = 20, which K13 pads to 24
# channels
CUDA_SHAPES = {"flagship B=100": (100, 50, 1, 8, 128, 28, 8),
               "flagship B=50": (50, 50, 1, 8, 128, 28, 8),
               "flagship B=1": (1, 50, 1, 8, 128, 28, 8),
               "mnist-b-p8": (100, 50, 1, 8, 128, 50, 25),
               "EMPIAR k=64": (20, 110, 1, 8, 128, 64, 16),
               "galaxy C=3": (8, 64, 3, 8, 128, 65, 16),
               "small images, N=40": (5, 12, 2, 1, 40, 3, 0),
               "odd side, N=96": (3, 17, 1, 4, 24, 6, 2),
               "odd k near n": (2, 30, 1, 8, 16, 29, 14),
               "N=20, padded": (3, 12, 1, 4, 5, 5, 2)}


def _check_rows(got, y, w, pad):
    """K13's rows against the float32 sums of the plain version's conv
    (cuDNN in float32, TF32 off): within one bf16 rounding of each sum
    (2^-8 of its size) and the float32 error of the sums' other order
    (1e-4 of the largest)."""
    x = y.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    torch.backends.cudnn.allow_tf32 = False
    s = F.conv2d(x, w.float(), padding=pad)
    b, n, ho, wo = s.shape
    s = s.permute(0, 2, 3, 1).reshape(-1, n)
    err = (got.float() - s).abs()
    tol = 2.0 ** -8 * s.abs() + 1e-4 * float(s.abs().max())
    assert got.shape == s.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert bool((err <= tol).all()), float((err - tol).max())
    plain = lift_conv_plain(y, w, pad)
    assert float((got.float() != plain.float()).float().mean()) < 0.01


@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_lift_conv_kernel_on_cuda(cuda, shape):
    """K13 against its plain version at the shapes the conv tier runs, one
    launch a call, and a rerun bitwise equal."""
    B, n, C, R, K, k, pad = CUDA_SHAPES[shape]
    y, w5 = _inputs(B, n, C, R, K, k, seed=4, device=cuda)
    w = lifted_weight(w5, R).to(torch.bfloat16)
    assert lift_conv_supported(tuple(y.shape), tuple(w.shape), pad)
    kernels.reset_launch_counts()
    got = lift_conv_fwd(y, w, pad)
    again = lift_conv_fwd(y, w, pad)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lift_conv_fwd"] == 2
    assert torch.equal(got, again)
    _check_rows(got, y, w, pad)


def test_lift_conv_reads_images_as_they_lie_on_cuda(cuda):
    """A one-channel batch whose channel stride is not 1 (as a (B, 1, H,
    W) batch permuted to channels-last leaves it) gives the rows of its
    contiguous copy."""
    y, w5 = _inputs(4, 50, 1, 8, 128, 28, seed=5, device=cuda)
    w = lifted_weight(w5, 8).to(torch.bfloat16)
    odd = y[..., 0][:, None].permute(0, 2, 3, 1)
    assert odd.stride(3) != 1
    assert torch.equal(lift_conv_fwd(odd, w, 8), lift_conv_fwd(y, w, 8))


def test_lift_conv_weight_gradient_on_cuda(cuda):
    """The flagship's encoder gradient on the card through _LiftConv (K13,
    then cuDNN's bf16 wgrad) against the cuDNN conv's autograd: the same
    wgrad on the same operands, so the filter bank's gradient differs only
    where the rows do (by a bf16 rounding at most) and in cuDNN's sum order:
    1e-2 relative L2."""
    B, n, C, R, K, k, pad = CUDA_SHAPES["flagship B=100"]
    y, w5 = _inputs(B, n, C, R, K, k, seed=6, device=cuda)
    hp = out_side(n, k, pad)
    g = torch.randn(B * hp * hp, R * K, generator=torch.Generator()
                    .manual_seed(7)).bfloat16().to(cuda)
    grads = []
    for fn in (lambda w: encoders.conv_rows(w, y, pad)[0],
               lambda w: _old_conv_rows(w, y, pad)):
        p = w5.clone().requires_grad_(True)
        fn(lifted_weight(p, R)).backward(g)
        grads.append(p.grad)
    torch.cuda.synchronize()
    rel = float((grads[0] - grads[1]).norm() / grads[1].norm())
    assert rel <= 1e-2, rel


def test_lift_conv_counts_on_an_embed_on_cuda(cuda):
    """A bf16 embed of 250 flagship images at B = 100 launches K13 once an
    encoder call (3) and counts no fallback of the lift."""
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.cli.clustering_common import embed_dataset
    from targetvae_tpu_torch.utils.config import (EncoderConfig,
                                                  GeneratorConfig,
                                                  ModelConfig)
    cfg = ModelConfig(GeneratorConfig(z_dim=2, fourier_expansion=True),
                      EncoderConfig(image_dim=50, kernels_num=128,
                                    kernels_size=28, padding=8, groupconv=8))
    model = TargetVAE(cfg, cuda)
    params = model.init(torch.Generator().manual_seed(0))
    images = np.random.default_rng(8).random((250, 50, 50, 1),
                                             dtype=np.float32)
    kernels.reset_launch_counts()
    z, rot, tr = embed_dataset(model, params, images, 100, "bfloat16")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["lift_conv_fwd"] == counts["mix_heads_fwd"] == 3
    assert counts["fallback.lift"] == 0
    assert np.isfinite(z).all() and z.shape == (250, 4)
