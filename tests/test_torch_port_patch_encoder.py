"""The port's patch encoder tier (TARGETVAE_ENCODER_TIER=patch; K11, K12) on
the CPU against the JAX package: build_patches, the plain versions of the
fused lifted encoder against the Pallas kernel in interpret mode (as
tests/test_kernels.py:30-40 runs it), the tier's encoder_apply, its
gradients, and one deterministic train step of the slice.

Inputs are made with numpy from a seed and handed to both sides; the shapes
are tests/test_kernels.py:22's small mode-C encoder. Every tolerance is
stated where it is used, with its reason.
"""

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

import targetvae_tpu_torch.kernels as kernels
import targetvae_tpu_torch.kernels.lifted_encoder as tle
import targetvae_tpu_torch.models.encoders as tenc
from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.kernels.lifted_encoder import (
    build_patches, fused_lifted_encoder, lifted_encoder_fwd,
    lifted_encoder_plain)
from targetvae_tpu_torch.losses.elbo import compute_elbo
from targetvae_tpu_torch.train import Trainer, create_train_state
from targetvae_tpu_torch.utils.config import EncoderConfig, TrainConfig
from targetvae_tpu_torch.utils.jax_params import params_from_jax

R, K, k, PAD, N_IMG = 4, 16, 8, 3, 14
HP = N_IMG + 2 * PAD - k + 1        # 13


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _enc_cfg(C=1, activation="leakyrelu", R=R, K=K):
    kw = dict(image_dim=N_IMG, z_dim=2, in_channels=C, kernels_num=K,
              kernels_size=k, padding=PAD, groupconv=R, activation=activation)
    return jcfg.EncoderConfig(**kw), EncoderConfig(**kw)


def _enc_params(jc):
    jp = jax.tree.map(np.asarray, EN.encoder_init(jax.random.key(0), jc))
    return jp, params_from_jax(jp)


def _images(B=3, C=1, seed=1):
    return np.random.default_rng(seed).uniform(
        size=(B, N_IMG, N_IMG, C)).astype(np.float32)


@pytest.fixture
def interpret_encoder(monkeypatch):
    """The JAX package's patch tier on the CPU: its gate open for mode C in
    bf16 and the Pallas kernel in interpret mode."""
    orig = LE.fused_lifted_encoder

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(LE, "fused_lifted_encoder", interp)
    monkeypatch.setattr(EN, "_use_encoder_kernel",
                        lambda cfg, dt: dt == jnp.bfloat16 and cfg.mode == "C")


@pytest.mark.parametrize("C", [1, 3])
def test_build_patches_matches_jax(C):
    """Exactly the JAX package's patches (both are copies of bf16 values),
    its tile rows past H' cut off."""
    B, tile_rows = 2, 5
    nt = -(-HP // tile_rows)
    xp = np.pad(_images(B, C), ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)))
    ref = np.asarray(LE.build_patches(jnp.asarray(xp), k, HP, HP, nt,
                                      tile_rows).astype(jnp.float32))
    ref = ref.reshape(B, nt * tile_rows, HP, -1)[:, :HP].reshape(B * HP * HP, -1)
    got = build_patches(torch.from_numpy(xp), k, HP, HP)
    assert got.dtype == torch.bfloat16 and got.shape == (B * HP * HP, C * k * k)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    if C == 1:    # a channel-less image stack gives the same patches
        assert torch.equal(
            build_patches(torch.from_numpy(xp[..., 0]), k, HP, HP), got)


@pytest.mark.parametrize("C, K_, R_, act", [
    pytest.param(C, K_, R_, act, id=str(C) if (K_, R_, act) == (
        K, R, "leakyrelu") else None)
    for C in (1, 3) for K_ in (16, 128) for R_ in (4, 16)
    for act in ("leakyrelu", "tanh")])
def test_patch_encoder_plain_matches_jax_kernel(C, K_, R_, act):
    """K11's plain version against the Pallas kernel (interpret mode),
    serving and with the saved h1, at the narrowest and widest K the
    kernels take, the fewest and most rotations mode C takes (4, 16), both
    activations. Both round h1
    and h2 to bf16 at the same points and differ only in f32 summation
    order: the heads within K1's
    5e-3 (tests/test_kernels.py:94's bound), h1 within one bf16 step of its
    largest magnitude. The rotated filter matrix is float32 model code on
    both sides: 1e-6."""
    jc, tc = _enc_cfg(C, act, R=R_, K=K_)
    jp, tp = _enc_params(jc)
    xp = np.pad(_images(3, C), ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)))
    jwc, jbc, jwh, jbh = EN._mode_c_matrices(jax.tree.map(jnp.asarray, jp), jc)
    wc, bc, wh, bh = tenc.mode_c_matrices(tp, tc)
    for a, b in ((wc, jwc), (bc, jbc), (wh, jwh), (bh, jbh)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    patches = LE.build_patches(jnp.asarray(xp), k, HP, HP, 1, HP)
    ref, ref_h1 = LE._fwd(patches, jwc, jbc, jnp.asarray(jp["conv2"]["w"]),
                          jnp.asarray(jp["conv2"]["b"]), jwh, jbh, R=R_, K=K_,
                          D=7, act_kind=act, interpret=True,
                          save_res=True)
    ref = np.asarray(ref).reshape(-1, R_ * 7)
    ref_h1 = np.asarray(ref_h1.astype(jnp.float32)).reshape(-1, R_ * K_)
    p = build_patches(torch.from_numpy(xp), k, HP, HP)
    w2, b2 = tp["conv2"]["w"], tp["conv2"]["b"]
    got, h1 = lifted_encoder_plain(p, wc, bc, w2, b2, wh, bh, R=R_, K=K_,
                                   act_kind=act, save_h1=True)
    assert got.shape == ref.shape and h1.dtype == torch.bfloat16
    assert float(np.abs(got.numpy() - ref).max()) < 5e-3
    assert (np.abs(h1.float().numpy() - ref_h1).max()
            <= np.abs(ref_h1).max() / 128)
    # on CPU tensors the wrapper is the plain version and counts nothing
    kernels.reset_launch_counts()
    torch.testing.assert_close(
        lifted_encoder_fwd(p, wc, bc, w2, b2, wh, bh, R=R_, K=K_,
                           act_kind=act), got,
        rtol=0, atol=0)
    assert kernels.launch_counts()["lifted_encoder_fwd"] == 0


def _sin_loss(heads):
    """sum(sin(head)) over the heads, of torch tensors or JAX arrays: the
    JAX encoder's five split heads, or the port's one tensor of them."""
    return sum((v.sin() if torch.is_tensor(v) else jnp.sin(v)).sum()
               for v in heads)


@pytest.mark.parametrize("activation", ["leakyrelu", "tanh"])
def test_patch_encoder_gradients_match_jax(interpret_encoder, activation):
    """The gradients of K12's plain version through the autograd Function
    against jax.grad of EN._mode_c_kernel (the Pallas backward in interpret
    mode), per parameter leaf, loss sum(sin(head)) as tests/test_kernels.py:
    97-120. Both take dWc from the bf16 dpre1, dbc from its f32 values and
    act' of the second layer from the f32 pre2. Bound 5e-6 relative L2 per
    leaf: for leaky ReLU only the f32 summation order remains (measured
    1.2e-7); for tanh, torch's and XLA's f32 tanh may differ by an ulp and
    flip an occasional bf16 rounding of h1 or h2 (measured 1.1e-6). Taking
    act' from the bf16 h2 instead, as K2 does, measures 3.0e-5 for tanh."""
    jc, tc = _enc_cfg(activation=activation)
    jp, tp = _enc_params(jc)
    y = _images()
    ref = jax.grad(lambda p: _sin_loss(EN._mode_c_kernel(p, jc, jnp.asarray(y))))(
        jax.tree.map(jnp.asarray, jp))
    for sub in tp.values():
        for t in sub.values():
            t.requires_grad_()
    _sin_loss((tenc._mode_c_patch_tier(tp, tc, torch.from_numpy(y)),)).backward()
    for name, sub in tp.items():
        for key, t in sub.items():
            assert _rel(t.grad.numpy(), ref[name][key]) < 5e-6, (name, key)


def test_patch_tier_encoder_apply_matches_jax(interpret_encoder, monkeypatch):
    """The bf16 patch tier's encoder_apply against the JAX package's
    (its _mode_c_kernel with the rotation prior and offsets), every output:
    the kernels' bf16 rounding, 5e-3 absolute as above; the log posterior
    sums the logits' errors over the grid's log-sum-exp, 1e-2."""
    monkeypatch.setenv("TARGETVAE_ENCODER_TIER", "patch")
    jc, tc = _enc_cfg()
    jp, tp = _enc_params(jc)
    y = _images()
    ref = EN.encoder_apply(jax.tree.map(jnp.asarray, jp), jc, jnp.asarray(y),
                           key=None, compute_dtype=jnp.bfloat16)
    with torch.inference_mode():
        got = tenc.encoder_apply(tp, tc, torch.from_numpy(y), None,
                                 torch.bfloat16)
    for name in ("attn", "theta_mu", "theta_logstd", "z_mu", "z_logstd"):
        assert float(np.abs(got[name].numpy()
                            - np.asarray(ref[name])).max()) < 5e-3, name
    assert float(np.abs(got["q"].numpy() - np.asarray(ref["q"])).max()) < 1e-2


def test_encoder_tier_switches_within_one_process(monkeypatch):
    """TARGETVAE_ENCODER_TIER is read at each call: one process runs the
    conv tier (K1's path), then the patch tier (K11's), then the conv tier
    again, and the float32 tier ignores it."""
    calls = []
    for name in ("fused_lift_act_mix_heads", "fused_lifted_encoder"):
        orig = getattr(tenc, name)
        monkeypatch.setattr(tenc, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    _, tc = _enc_cfg()
    _, tp = _enc_params(_enc_cfg()[0])
    y = torch.from_numpy(_images(2))
    seen = []
    for tier in (None, "patch", "conv", "patch"):
        if tier is None:
            monkeypatch.delenv("TARGETVAE_ENCODER_TIER", raising=False)
        else:
            monkeypatch.setenv("TARGETVAE_ENCODER_TIER", tier)
        seen.append(kernels.encoder_tier())
        with torch.inference_mode():
            tenc.encoder_apply(tp, tc, y, None, torch.bfloat16)
            tenc.encoder_apply(tp, tc, y, None, None)
    assert seen == ["conv", "patch", "conv", "patch"]
    assert calls == ["fused_lift_act_mix_heads", "fused_lifted_encoder",
                     "fused_lift_act_mix_heads", "fused_lifted_encoder"]


# ---- the slice: one deterministic patch-tier train step ----

def _model_config():
    """tests/test_torch_port_slice.py's small config."""
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(z_dim=2, hidden_dim=64, n_out=1,
                                       num_layers=2, fourier_expansion=True,
                                       fourier_sigma=2.0 / 13,
                                       embedding_dim=64),
        encoder=jcfg.EncoderConfig(image_dim=N_IMG, z_dim=2, kernels_num=K,
                                   kernels_size=k, padding=PAD, groupconv=R),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


def test_patch_tier_train_step(interpret_encoder, monkeypatch):
    """A deterministic bf16 train step on the patch tier (no noise on
    either side). Its ELBO against the JAX package's bf16 ELBO with the
    patch encoder engaged (interpret mode): the encoders agree as above,
    and the decoders round alike but are two algorithms (the port's pose
    decoder builds separable features, JAX on the CPU takes its XLA bf16
    path): measured 2.4e-6 relative at hidden 64, bound 1e-4. Its
    gradients against the port's float32 tier (measured worst 0.012, the
    lift's bias),
    per leaf: bf16 operands at this size, the bound
    tests/test_torch_port_train.py holds the conv tier to (0.15, the theta
    heads 0.2); the attention bias's exact gradient is zero (a common shift
    of the logits) and holds rounding noise only. The step itself reports
    that ELBO and moves every parameter."""
    monkeypatch.setenv("TARGETVAE_ENCODER_TIER", "patch")
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(EN, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))
    jc = _model_config()
    jm = JaxTargetVAE(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    y = np.random.default_rng(0).uniform(size=(4, N_IMG, N_IMG, 1)).astype(
        np.float32)
    ref = float(jax_compute_elbo(jax.tree.map(jnp.asarray, jp), jc,
                                 jm.base_grid(), jnp.asarray(y),
                                 jax.random.key(1),
                                 compute_dtype=jnp.bfloat16)[0])

    def grads(dt):
        tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
        tm.load_params(params_from_jax(jp))
        elbo = compute_elbo(tm.params(), tm.cfg, tm.base_grid(),
                            torch.from_numpy(y), None, dt)[0]
        (-elbo).backward()
        return float(elbo.detach()), {n: p.grad.numpy()
                                      for n, p in tm.named_parameters()}

    e16, g16 = grads(torch.bfloat16)
    _, g32 = grads(None)
    assert abs(e16 - ref) < 1e-4 * abs(ref), (e16, ref)
    for name, g in g16.items():
        assert np.isfinite(g).all(), name
        if name == "encoder.conv_a.b":
            assert np.abs(g).max() < 1e-4 and np.abs(g32[name]).max() < 1e-4
        else:
            bound = 0.2 if name.startswith("encoder.conv_r") else 0.15
            assert _rel(g, g32[name]) < bound, (name, _rel(g, g32[name]))

    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.load_params(params_from_jax(jp))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    trainer = Trainer(tm, TrainConfig(compute_dtype="bfloat16"))
    state, metrics = trainer.train_step(create_train_state(tm, 2e-4, None), y)
    assert state.step == 1
    assert float(metrics[0]) == pytest.approx(e16, rel=1e-6)
    moved = {n for n, p in tm.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved == set(before)


def test_fused_lifted_encoder_serves_without_saving(monkeypatch):
    """Without a gradient to take the Function is skipped (serving keeps no
    h1); with one, the saved-h1 forward and K12 run."""
    seen = []
    orig = tle.lifted_encoder_fwd
    monkeypatch.setattr(tle, "lifted_encoder_fwd", lambda *a, **kw: (
        seen.append(kw.get("save_h1", False)), orig(*a, **kw))[1])
    jc, tc = _enc_cfg()
    _, tp = _enc_params(jc)
    wc, bc, wh, bh = tenc.mode_c_matrices(tp, tc)
    xp = np.pad(_images(2), ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)))
    p = build_patches(torch.from_numpy(xp), k, HP, HP)
    args = (p, wc, bc, tp["conv2"]["w"], tp["conv2"]["b"], wh, bh)
    with torch.no_grad():
        served = fused_lifted_encoder(*args, R=R, K=K)
    wc.requires_grad_()
    trained = fused_lifted_encoder(*args, R=R, K=K)
    trained.sum().backward()
    assert seen == [False, True]
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=0)
    assert wc.grad is not None and wc.grad.shape == wc.shape
