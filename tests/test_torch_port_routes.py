"""The bf16 tier's routes past its kernels' widths, on the CPU against the
JAX package.

The kernels take fixed widths: the decoders (K7-K10) hidden in 64, 128,
256, 512, F % 32 (K7) or F % 64 (K8-K10) and n_out <= 8 (K7, K8, K10);
the encoders (K1, K2, K11, K12) at most 16 heads, D = 3 + 2 z_dim; the
posterior (K3, K4) z_dim <= 8. The JAX package computes any width, so past
them the port's bf16 tier runs the JAX package's XLA bf16 recipe in plain
PyTorch, the route fixed by the config before any launch. On the CPU
every wrapper takes its plain version whatever the width, so these tests
read the route from the functions the model calls and hold its numbers
against the JAX package's bf16 path.

Inputs are made with numpy from seeds and handed to both sides. Every
tolerance is stated where it is used, with its reason.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import targetvae_tpu.kernels.lifted_encoder as LE
import targetvae_tpu.models.encoders as EN
from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.utils import config as jcfg

import targetvae_tpu_torch.kernels.posterior as tpost
import targetvae_tpu_torch.losses.elbo as telbo
import targetvae_tpu_torch.models.encoders as tenc
import targetvae_tpu_torch.models.generator as tgen
from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.kernels.decoder_mlp import decoder_kernel_supported
from targetvae_tpu_torch.kernels.decoder_pose import pose_decoder_supported
from targetvae_tpu_torch.kernels.posterior import posterior_kernel_supported
from targetvae_tpu_torch.losses.elbo import compute_elbo, reconstruct_log_prob
from targetvae_tpu_torch.ops.coords import transform_coords
from targetvae_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

N_IMG = 14


def _rel(a, b) -> float:
    """Relative L2 distance of a from the reference b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _config(zd=2, **gen):
    """tests/test_torch_port_train.py's small mode-C model (14x14 images,
    K=16, P4, F=64, hidden 32), with z_dim zd and generator options."""
    g = dict(z_dim=zd, hidden_dim=32, n_out=1, num_layers=2,
             fourier_expansion=True, fourier_sigma=2.0 / 13, embedding_dim=64)
    g.update(gen)
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(**g),
        encoder=jcfg.EncoderConfig(image_dim=N_IMG, z_dim=zd, kernels_num=16,
                                   kernels_size=8, padding=3, groupconv=4),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


def _pair(jc, seed=0):
    jm = JaxTargetVAE(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.load_params(params_from_jax(jp))
    return jm, jp, tm


def _images(n=3, seed=0, c=1):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, N_IMG, N_IMG, c)).astype(np.float32)


@contextlib.contextmanager
def _jax_without_noise():
    """The JAX side without sampling noise, as the zero_noise fixture of
    tests/test_torch_port_train.py: zero reparameterisation normals, the
    plain softmax for the Gumbel sample. The port's counterpart is
    generator=None. Only around the loss: the initialisers draw normals."""
    saved = jax.random.normal, EN.gumbel_softmax
    jax.random.normal = (lambda key, shape=(), dtype=jnp.float32:
                         jnp.zeros(shape, dtype))
    EN.gumbel_softmax = (lambda key, logits, tau=1.0, axis=-1:
                         jax.nn.softmax(logits, axis=axis))
    try:
        yield
    finally:
        jax.random.normal, EN.gumbel_softmax = saved


def _jax_grads(jm, jp, y, dt):
    """(-elbo, its gradient) of the JAX package's ELBO, no noise, as numpy;
    the Fourier buffers left out."""
    with _jax_without_noise():
        loss = lambda p: -jax_compute_elbo(p, jm.cfg, jm.base_grid(),
                                           jnp.asarray(y), jax.random.key(1),
                                           compute_dtype=dt)[0]
        value, g = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, jp))
    g = jax.tree.map(np.asarray, g)
    g["generator"].pop("fourier")
    return float(value), g


def _port_grads(tm, y, dt):
    """(-elbo, its gradient) of the port's ELBO, no noise, as the JAX
    pytree of numpy arrays; the Fourier buffers get none."""
    params = tm.params()
    elbo = compute_elbo(params, tm.cfg, tm.base_grid(), torch.from_numpy(y),
                        None, dt)[0]
    (-elbo).backward()
    trained = {"encoder": params["encoder"],
               "generator": {k: v for k, v in params["generator"].items()
                             if k != "fourier"}}
    return -float(elbo.detach()), params_to_jax(jax.tree.map(
        lambda p: p.grad, trained, is_leaf=torch.is_tensor))


def _assert_leaves(got, ref, tol, tol_theta=None):
    """Each leaf of `got` within `tol` relative L2 of `ref`'s (the theta
    heads, encoder conv_r, within `tol_theta` if given), but the attention
    head's bias: the joint softmax ignores a shift of every logit, so its
    exact gradient is zero and both sides hold rounding noise; it is held
    to |g| < 1e-4 instead."""
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        keys = tuple(k.key if hasattr(k, "key") else k.idx for k in path)
        r = ref
        for k in keys:
            r = r[k]
        assert np.isfinite(g).all(), keys
        if keys == ("encoder", "conv_a", "b"):
            assert np.abs(g).max() < 1e-4 and np.abs(r).max() < 1e-4
        else:
            bound = tol_theta if keys[:2] == ("encoder", "conv_r") else tol
            assert _rel(g, r) < (bound or tol), (keys, _rel(g, r))


# ---- F1: the generator past the decoder kernels' widths ----

# (hidden, F, n_out): hidden 384 no decoder kernel takes; F = 96 K7 takes
# (F % 32) and K8, K9, K10 do not (F % 64); n_out 3 all four take; n_out 9
# only K9 (it forms the heads 16 at a time)
GENERATOR_WIDTHS = [(384, 64, 1), (64, 96, 1), (64, 64, 3), (64, 64, 9)]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("hidden, F, n_out", GENERATOR_WIDTHS)
def test_generator_routes_to_the_kernels_where_they_take_the_widths(
        monkeypatch, hidden, F, n_out, grad):
    """The bf16 reconstruction runs the pose decoder (K7, K8 under
    autograd) where it takes the generator's widths in the direction
    asked, else transform_coords and generator_apply, which runs K9 (K10)
    where they take them and the XLA bf16 recipe elsewhere. Read from the
    functions the model calls on the CPU; the route with a gradient also
    runs its backward."""
    jc = _config(hidden_dim=hidden, embedding_dim=F, n_out=n_out)
    cfg = ModelConfig.from_json(jc.to_json()).generator
    pose = pose_decoder_supported(cfg, grad)
    mlp = decoder_kernel_supported(cfg, grad)
    assert pose is ((hidden, F, n_out) == (64, 64, 3)
                    or ((hidden, F, n_out) == (64, 96, 1) and not grad))
    assert mlp is ((hidden, F, n_out) == (64, 64, 3)
                   or ((hidden, F, n_out) == (64, 64, 9) and not grad))
    calls = {"pose": 0, "mlp": 0}
    for mod, name, key in ((telbo, "fused_pose_decoder", "pose"),
                           (tgen, "fused_decoder_mlp", "mlp")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a, **kw))[1])
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(grad)
    rng = np.random.default_rng(1)
    theta, dx, z = (torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                     * 0.3) for s in ((2,), (2, 2), (2, 2)))
    y = torch.from_numpy(_images(2, c=n_out))        # a channel an output
    log_p = reconstruct_log_prob(params, tm.cfg, tm.base_grid(), y, theta, dx,
                                 z, torch.bfloat16)
    assert bool(torch.isfinite(log_p).all())
    assert calls == {"pose": int(pose), "mlp": int(not pose and mlp)}
    if grad:
        log_p.sum().backward()
        assert bool(torch.isfinite(params["generator"]["coord_linear"]["w"]
                                   .grad).all())


@pytest.fixture
def patch_tier_both_sides(monkeypatch):
    """The patch encoder tier on both sides, so that the two encoders round
    alike (tests/test_torch_port_decoder_mlp.py's bf16 ELBO test): the port
    through TARGETVAE_ENCODER_TIER, the JAX package through its gate, its
    Pallas kernel in interpret mode."""
    monkeypatch.setenv("TARGETVAE_ENCODER_TIER", "patch")
    orig = LE.fused_lifted_encoder
    monkeypatch.setattr(LE, "fused_lifted_encoder",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(EN, "_use_encoder_kernel",
                        lambda cfg, dt: dt == jnp.bfloat16)


def test_bf16_hidden_384_matches_jax(patch_tier_both_sides):
    """At hidden 384, a width no decoder kernel takes, the port's bf16 ELBO,
    its gradients and decode against the JAX package's bf16 path on the CPU
    (the same weights, no noise), which decodes with its XLA bf16 recipe
    as the port now does. The ELBO within 1e-4 relative and each gradient
    leaf within 1e-2 relative L2 (the bounds tests/test_torch_port_decoder_
    mlp.py holds the bf16 ELBO and the kernels' gradients to against the
    JAX package); decode within 1e-4 absolute (the same recipe both sides;
    f32 sums of 384 terms in another order: measured 3.1e-5)."""
    jm, jp, tm = _pair(_config(hidden_dim=384))
    assert not pose_decoder_supported(tm.cfg.generator, True)
    assert not decoder_kernel_supported(tm.cfg.generator)
    y = _images()
    ref_loss, ref_g = _jax_grads(jm, jp, y, jnp.bfloat16)
    loss, g = _port_grads(tm, y, torch.bfloat16)
    assert abs(loss - ref_loss) < 1e-4 * abs(ref_loss), (loss, ref_loss)
    _assert_leaves(g, ref_g, 1e-2)
    rng = np.random.default_rng(13)
    theta, dx, z = (rng.normal(size=s).astype(np.float32)
                    for s in ((3,), (3, 2), (3, 2)))
    x = transform_coords(tm.base_grid(), torch.from_numpy(dx) * 0.2,
                         torch.from_numpy(theta))
    ref = np.asarray(jm.decode(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(x.numpy()), jnp.asarray(z),
                               compute_dtype=jnp.bfloat16))
    with torch.inference_mode():
        got = tm.decode(tm.params(), x, torch.from_numpy(z), torch.bfloat16)
    assert got.shape == ref.shape == (3, N_IMG * N_IMG, 1)
    assert float(np.abs(got.numpy() - ref).max()) < 1e-4


# ---- F2: z_dim past the encoder's and the posterior's kernels ----

@contextlib.contextmanager
def _jax_bf16_recipe():
    """The JAX package's bf16 mode-C encoder on its TPU tier's XLA recipe
    (targetvae_tpu/models/encoders.py::_mode_c_xla_matmul without its
    kernel), which its CPU path does not take: the function the port's
    _mode_c_bf16_recipe computes (tools/calibrate_zdim_grad_tol.py)."""
    saved = EN._use_encoder_kernel, EN._mode_c_kernel
    EN._use_encoder_kernel = lambda cfg, dt: dt == jnp.bfloat16
    EN._mode_c_kernel = lambda p, cfg, y: EN._mode_c_xla_matmul(
        p, cfg, y, allow_kernels=False)
    try:
        yield
    finally:
        EN._use_encoder_kernel, EN._mode_c_kernel = saved


@pytest.mark.parametrize("zd", [8, 10])
def test_bf16_wide_latent_routes_track_jax(monkeypatch, zd):
    """At z_dim 8 (19 heads: past the encoder kernels' 16; the posterior
    on K3/K4) and 10 (past both) the bf16 tier runs the XLA bf16 recipe
    for the encoder and, at 10, encoder_apply and the posterior's model
    code, the routes chosen from the config before any launch.

    Its heads track the JAX package's bf16 encoder_apply on the CPU (the
    lift conv in bf16, the rest in float32) within 1e-2 relative L2, as
    the K = 160 test of tests/test_torch_port_train.py holds them; its
    gradients track the JAX package's bf16 gradients with its TPU tier's
    XLA recipe within 1e-2 relative L2 per leaf (the same function, sums
    in another order: measured <= 2e-4 over 8 seeds).

    It trains: its gradients track its own float32 tier's within 0.15
    relative L2 per leaf and within 0.1 for the theta heads (conv_r).
    tools/calibrate_zdim_grad_tol.py measured the JAX package's bf16
    recipe against float32 at this size over 8 seeds: worst 0.0755 (z_dim
    8) and 0.0886 (10) on the other leaves, 0.0369 and 0.0538 on the
    theta heads; the bounds are about 1.7 and 1.9 times those. The
    package's CPU bf16 path, which rounds only the lift, reaches 0.219 on
    the theta heads at z_dim 8: the cancellation in conv_r's gradient that
    failed the 0.2 bound of the narrower configs there."""
    jc = _config(zd)
    jm, jp, tm = _pair(jc)
    ecfg = tm.cfg.encoder
    assert not any(tenc.encoder_kernel_supported(ecfg, tier, grad)
                   for tier in ("conv", "patch") for grad in (False, True))
    assert posterior_kernel_supported(ecfg) is (zd <= 8)
    routes = {"recipe": 0, "posterior": 0, "apply": 0}
    for mod, name, key in ((tenc, "_mode_c_bf16_recipe", "recipe"),
                           (tpost, "posterior_plain", "posterior"),
                           (telbo, "encoder_apply", "apply")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **kw: (
            routes.__setitem__(_k, routes[_k] + 1), _r(*a, **kw))[1])
    y = _images()
    ref = EN.encoder_apply(jax.tree.map(jnp.asarray, jp["encoder"]),
                           jc.encoder, jnp.asarray(y), None,
                           compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = tenc.encoder_apply(tm.params()["encoder"], ecfg,
                                 torch.from_numpy(y), None, torch.bfloat16)
    for name in ("attn", "theta_mu", "theta_logstd", "z_mu", "z_logstd"):
        assert _rel(got[name].numpy(), np.asarray(ref[name])) < 1e-2, name
    routes.update(recipe=0, posterior=0, apply=0)
    _, g16 = _port_grads(tm, y, torch.bfloat16)
    assert routes == {"recipe": 1, "posterior": int(zd <= 8),
                      "apply": int(zd > 8)}
    with _jax_bf16_recipe():
        _, ref_g = _jax_grads(jm, jp, y, jnp.bfloat16)
    _assert_leaves(g16, ref_g, 1e-2)
    _, g32 = _port_grads(_pair(jc)[2], y, None)
    _assert_leaves(g16, g32, 0.15, tol_theta=0.1)
