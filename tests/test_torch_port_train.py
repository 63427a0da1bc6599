"""The port's training slice against the JAX package on the CPU: the three
backward kernels' plain versions against jax.vjp of the Pallas kernels (in
interpret mode, as tests/test_kernels.py runs them), the ELBO's gradient,
Adam, and one Trainer step; plus the bf16 tier's gradients and the default
device rule.

Inputs are made with numpy from a seed and handed to both sides. Every
tolerance is stated where it is used, with its reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import targetvae_tpu.models.encoders as jax_enc
from targetvae_tpu.kernels.decoder_pose import (
    fused_pose_decoder as jax_pose_decoder)
from targetvae_tpu.kernels.mix_heads import (
    fused_lift_act_mix_heads as jax_mix_heads)
from targetvae_tpu.kernels.posterior import fused_posterior as jax_posterior
from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.models.generator import generator_init as jax_gen_init
from targetvae_tpu.train.loop import Trainer as JaxTrainer
from targetvae_tpu.train.state import create_train_state as jax_train_state
from targetvae_tpu.train.state import make_optimizer as jax_optimizer
from targetvae_tpu.utils import config as jcfg

from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.kernels.decoder_pose import fused_pose_decoder
from targetvae_tpu_torch.kernels.mix_heads import (
    fused_lift_act_mix_heads, lift_act_mix_heads_bwd_plain)
from targetvae_tpu_torch.kernels.posterior import (
    fused_posterior, per_image_gumbel, posterior_bwd_plain, posterior_plain)
import targetvae_tpu_torch.losses.elbo as port_elbo
import targetvae_tpu_torch.models.encoders as port_enc
from targetvae_tpu_torch.losses.elbo import compute_elbo
from targetvae_tpu_torch.train import (
    Trainer, create_train_state, get_learning_rate, make_optimizer,
    set_learning_rate)
from targetvae_tpu_torch.utils.config import (EncoderConfig, GeneratorConfig,
                                              TrainConfig)
from targetvae_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

LR = 2e-4


def _rel(a, b) -> float:
    """Relative L2 distance of a from the reference b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _keys(path):
    return tuple(k.key if hasattr(k, "key") else k.idx for k in path)


def _assert_grads_close(got, ref, tol, tol_theta=None):
    """Each leaf of the gradient tree `got` within `tol` relative L2 of the
    matching leaf of `ref` (the theta heads, encoder conv_r, within
    `tol_theta` if given). The attention head's bias is the exception: the
    joint softmax is invariant to a shift of every logit, so its exact
    gradient is zero and both sides hold rounding noise; it is held to
    |g| < 1e-4 instead."""
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        keys = _keys(path)
        r = ref
        for k in keys:
            r = r[k]
        if keys == ("encoder", "conv_a", "b"):
            assert np.abs(g).max() < 1e-4 and np.abs(r).max() < 1e-4
        else:
            bound = tol_theta if keys[:2] == ("encoder", "conv_r") else tol
            assert _rel(g, r) < (bound or tol), (keys, _rel(g, r))


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _model_config():
    """tests/test_torch_port_slice.py's small config."""
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(z_dim=2, hidden_dim=32, n_out=1,
                                       num_layers=2, fourier_expansion=True,
                                       fourier_sigma=2.0 / 13,
                                       embedding_dim=64),
        encoder=jcfg.EncoderConfig(image_dim=14, z_dim=2, kernels_num=16,
                                   kernels_size=8, padding=3, groupconv=4),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


@pytest.fixture
def zero_noise(monkeypatch):
    """The JAX side without sampling noise, as tests/test_elbo.py does: the
    reparameterisation normals are zero and the Gumbel sample is the plain
    softmax. The port's counterpart is generator=None."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax_enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))


@pytest.fixture(scope="module")
def pair():
    jc = _model_config()
    jm = JaxTargetVAE(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    images = np.random.default_rng(0).uniform(0, 1, (6, 14, 14, 1)).astype(
        np.float32)
    return jm, jp, images


def _port_model(jm, jp):
    tm = TargetVAE(ModelConfig.from_json(jm.cfg.to_json()), device="cpu")
    tm.load_params(params_from_jax(jp))
    return tm


def _port_grads(tm, y, compute_dtype=None):
    """Gradients of -ELBO (no noise) as the JAX pytree of numpy arrays; the
    Fourier buffers get none and are left out."""
    params = tm.params()
    elbo, _, _ = compute_elbo(params, tm.cfg, tm.base_grid(),
                              torch.from_numpy(y), None, compute_dtype)
    (-elbo).backward()
    trained = {"encoder": params["encoder"],
               "generator": {k: v for k, v in params["generator"].items()
                             if k != "fourier"}}
    return params_to_jax(jax.tree.map(lambda p: p.grad, trained,
                                      is_leaf=torch.is_tensor))


# ---- the backward kernels' plain versions against the Pallas kernels ----

def test_mix_heads_backward_plain_matches_jax_kernel():
    """K2 at tests/test_kernels.py:480's shapes, all six cotangents. Both
    sides round at the same points and differ in summation order: the f32
    gradients within 1e-4 relative L2, the bf16 dpre1 within one bf16 step
    (2^-7 of its largest magnitude)."""
    R, K, D, N = 4, 128, 7, 700
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = (f(N, R * K) * 0.5, f(R * K) * 0.1, f(K, K) * 0.05, f(K) * 0.1,
            f(K, D) * 0.1, f(D) * 0.1)
    g = f(N, R * D)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda *a: jax_mix_heads(*a, R=R, K=K,
                                              act_kind="leakyrelu",
                                              interpret=True), *jargs)
    ref = [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))]
    targs = [torch.from_numpy(a) for a in args]
    targs[0] = targs[0].to(torch.bfloat16)
    got = lift_act_mix_heads_bwd_plain(*targs[:5], torch.from_numpy(g), R=R,
                                       K=K)
    assert got[0].dtype == torch.bfloat16
    scale = np.abs(ref[0]).max()
    assert np.abs(got[0].float().numpy() - ref[0]).max() <= scale / 128
    for i in range(1, 6):
        assert _rel(got[i].numpy(), ref[i]) < 1e-4, i
    # the CPU autograd Function's backward is exactly the plain backward
    leaves = [t.clone().requires_grad_() for t in targs]
    out = fused_lift_act_mix_heads(*leaves, R=R, K=K)
    out.backward(torch.from_numpy(g))
    for leaf, want in zip(leaves, got):
        assert torch.equal(leaf.grad, want)


def _posterior_inputs(B=3, R=4, M=25, zd=2):
    """tests/test_kernels.py:218's shapes, under the heads contract: raw
    heads (B, M, R, D), log p(r), offsets (R,), p_tr (M, R), grid (M, 2),
    sig_r (numpy)."""
    rng = np.random.default_rng(1)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    scale = np.asarray([2.0, 1.0, 0.3] + [1.0] * zd + [0.3] * zd, np.float32)
    p = f(M * R)
    p_tr = (p - np.log(np.exp(p - p.max()).sum()) - p.max()).reshape(M, R)
    return (f(B, M, R, 3 + 2 * zd) * scale, f(R) * 0.5 - np.float32(2.5),
            np.asarray([0, np.pi / 2, np.pi, -np.pi / 2], np.float32),
            p_tr.astype(np.float32), f(M, 2), float(np.pi / 4))


_POST_KEYS = ("z_mu_e", "z_std_e", "theta_mu_e", "theta_std_e", "dx", "kl")


def _packed_cotangent(g, zd):
    return {"z_mu_e": g[:, :zd], "z_std_e": g[:, zd:2 * zd],
            "theta_mu_e": g[:, 2 * zd], "theta_std_e": g[:, 2 * zd + 1],
            "dx": g[:, 2 * zd + 2:2 * zd + 4], "kl": g[:, 2 * zd + 4]}


def test_posterior_backward_plain_matches_jax_kernel():
    """K4's plain version, deterministic, against the JAX kernel's
    hand-derived VJP taken at the planes the JAX package's ELBO forms from
    the same heads (log p(r) added to the logit, the offsets to theta's
    mean): the cotangent of the raw heads is the planes' cotangents in the
    heads' layout. Both float32 with the same formulas, so 1e-4 relative
    per element (floored at 1)."""
    heads, p_r, offs, p_tr, grid, sig_r = _posterior_inputs()
    zd = 2
    hp = heads.transpose(0, 3, 2, 1)                              # (B, D, R, M)
    planes = (hp[:, 0] + p_r[:, None], hp[:, 1] + offs[:, None], hp[:, 2],
              hp[:, 3:3 + zd], hp[:, 3 + zd:])
    g = np.random.default_rng(2).normal(size=(3, 9)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: jax_posterior(jax.random.key(9), *a, jnp.asarray(p_tr.T),
                                 jnp.asarray(grid), jnp.asarray(offs), sig_r,
                                 deterministic=True, interpret=True),
        *map(jnp.asarray, planes))
    ref = [np.asarray(r) for r in vjp(
        {k: jnp.asarray(v) for k, v in _packed_cotangent(g, zd).items()})]
    ref = np.concatenate([ref[0][:, None], ref[1][:, None], ref[2][:, None],
                          ref[3], ref[4]], axis=1).transpose(0, 3, 2, 1)
    got = posterior_bwd_plain(torch.from_numpy(g),
                              *map(torch.from_numpy, (heads, p_r, offs, p_tr,
                                                      grid)), sig_r)
    assert got.shape == heads.shape
    assert (np.abs(got.numpy() - ref) / np.maximum(np.abs(ref), 1.0)).max() < 1e-4


def test_posterior_sampled_cpu_backward_is_autograd_of_plain():
    """The CPU Function's sampled backward regenerates the forward's noise
    from the seed: its heads cotangent equals torch.autograd of
    posterior_plain fed the same per_image_gumbel noise (float32, two
    formulas of one derivative: 1e-5 relative per element, floored at 1)."""
    heads, *consts = _posterior_inputs()
    g = torch.from_numpy(
        np.random.default_rng(3).normal(size=(3, 9)).astype(np.float32))
    cot = _packed_cotangent(g, 2)
    consts = [torch.from_numpy(a) for a in consts[:4]] + [consts[4]]

    def grads(fn):
        leaf = torch.from_numpy(heads).requires_grad_()
        out = fn(leaf)
        sum((out[k] * cot[k]).sum() for k in _POST_KEYS).backward()
        return leaf.grad

    got = grads(lambda h: fused_posterior(17, h, *consts))
    noise = per_image_gumbel(17, (3, 4, 25))
    ref = grads(lambda h: posterior_plain(h, *consts, noise=noise))
    assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) < 1e-5


def test_kernel_tier_elbo_heads_gradient_equals_the_plane_route(pair,
                                                               monkeypatch):
    """The bf16 tier's ELBO hands the encoder's raw heads to the posterior
    (K3/K4, their plain versions on the CPU) as they lie. Its gradient with
    respect to those heads equals autograd through the float32 tier's plane
    route from the same heads: encoder_apply's split with log p(r) and the
    offsets added, then the posterior in plain model code. No noise, and
    the decoder replaced on both sides by one smooth function of (theta,
    dx, z), so that only the posterior's wiring (cell order, the (M, R)
    prior, the offsets) is compared: float32 on both sides, 1e-5 relative
    L2; the ELBOs within 1e-6 relative."""
    jm, jp, images = pair
    tm = _port_model(jm, jp)
    params, y = tm.params(), torch.from_numpy(images)
    with torch.no_grad():
        heads = port_enc.encoder_heads(params["encoder"], tm.cfg.encoder, y)
    heads = heads + 0.3 * torch.randn(heads.shape, generator=torch.Generator(
        ).manual_seed(4))
    monkeypatch.setattr(
        port_elbo, "reconstruct_log_prob",
        lambda params, cfg, x, y, theta, dx, z, compute_dtype=None,
        row_weights=None, ctf=None: (torch.sin(theta).sum()
                                     + torch.cos(3 * dx).sum()
         + (z * z).sum()) / y.shape[0])
    grads, elbos = [], []
    for dt, module in ((torch.bfloat16, port_elbo), (None, port_enc)):
        leaf = heads.clone().requires_grad_()
        with monkeypatch.context() as m:
            m.setattr(module, "encoder_heads", lambda *a, **k: leaf)
            elbo = compute_elbo(params, tm.cfg, tm.base_grid(), y, None, dt)[0]
        elbo.backward()
        grads.append(leaf.grad.numpy())
        elbos.append(float(elbo.detach()))
    assert abs(elbos[0] - elbos[1]) <= 1e-6 * abs(elbos[1])
    assert _rel(*grads) < 1e-5


@pytest.mark.parametrize("num_layers", [2, 4])
def test_pose_decoder_backward_plain_matches_jax_kernel(num_layers):
    """K8 with its pose closure against jax.vjp of the Pallas kernel at
    tests/test_kernels.py:135-142's shapes. Both sides run the same bf16
    rounding points, but the tables' cos/sin and the f32 sums differ by an
    ulp or so, which can move a bf16 feature or h by one step and flip a
    leaky slope near zero: measured up to 4.5e-3 relative L2 (dz, image 2
    of 3), so every leaf within 1e-2."""
    n, zd = 18, 2
    cfg = GeneratorConfig(z_dim=zd, hidden_dim=64, num_layers=num_layers,
                          n_out=1, fourier_expansion=True,
                          fourier_sigma=2 / (n - 1))
    jgc = jcfg.GeneratorConfig(**cfg.__dict__)
    jp = jax.tree.map(np.asarray, jax_gen_init(jax.random.key(0), jgc))
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(3,)).astype(np.float32)
    dx = (rng.normal(size=(3, 2)) * 0.2).astype(np.float32)
    z = rng.normal(size=(3, zd)).astype(np.float32)
    g = rng.normal(size=(3, n * n, 1)).astype(np.float32)

    def jfn(theta, dx, z, params):
        return jax_pose_decoder(theta, dx, z, params, jgc, n, tr=8,
                                interpret=True)

    _, vjp = jax.vjp(jfn, jnp.asarray(theta), jnp.asarray(dx), jnp.asarray(z),
                     jax.tree.map(jnp.asarray, jp))
    r_theta, r_dx, r_z, r_params = vjp(jnp.asarray(g))

    tp = params_from_jax(jp)
    leaves = [p.requires_grad_() for k, sub in tp.items() if k != "fourier"
              for p in (sub.values() if isinstance(sub, dict)
                        else [x for h in sub for x in h.values()])]
    t_theta, t_dx, t_z = (_t(a, True) for a in (theta, dx, z))
    y = fused_pose_decoder(t_theta, t_dx, t_z, tp, cfg, n)
    y.backward(torch.from_numpy(g))
    assert leaves and all(p.grad is not None for p in leaves)
    for got, ref in ((t_theta, r_theta), (t_dx, r_dx), (t_z, r_z)):
        assert _rel(got.grad.numpy(), ref) < 1e-2
    for name in ("coord_linear", "latent_linear", "out"):
        for k, p in tp[name].items():
            assert _rel(p.grad.numpy(), r_params[name][k]) < 1e-2, (name, k)
    for h, rh in zip(tp["hidden"], r_params["hidden"]):
        for k, p in h.items():
            assert _rel(p.grad.numpy(), rh[k]) < 1e-2, ("hidden", k)


# ---- the model, the optimizer, the step ----

def test_elbo_gradient_matches_jax(pair, zero_noise):
    """Gradient of -ELBO over every parameter, the port's float32 tier
    against jax.grad, no noise: float32 on both sides, summed in other
    orders (2e-4 relative L2, the forward's own tolerance)."""
    jm, jp, images = pair
    y = images[:4]
    ref = jax.grad(lambda p: -jax_compute_elbo(
        p, jm.cfg, jm.base_grid(), jnp.asarray(y), jax.random.key(1))[0])(
        jax.tree.map(jnp.asarray, jp))
    _assert_grads_close(_port_grads(_port_model(jm, jp), y), ref, 2e-4)
    # the Fourier buffers are constants on both sides
    assert not np.asarray(ref["generator"]["fourier"]["w"]).any()


def test_adam_matches_optax():
    """Three steps of the port's Adam and of the JAX package's optax.adam on
    identical gradients, then a learning-rate change and a fourth step:
    float32 updates of ~lr per step, equal to 1e-6."""
    rng = np.random.default_rng(5)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((7, 5), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 10 ** -i
              for p in p0] for i in range(4)]
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = make_optimizer(tparams, LR)
    jopt = jax_optimizer(LR)
    jparams = [jnp.asarray(p) for p in p0]
    jstate = jopt.init(jparams)
    for i, gs in enumerate(grads):
        if i == 3:
            for group in opt.param_groups:
                group["lr"] = 1e-3
            jstate.hyperparams["learning_rate"] = jnp.asarray(1e-3)
        for p, g in zip(tparams, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
        upd, jstate = jopt.update([jnp.asarray(g) for g in gs], jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                       rtol=0, atol=1e-6)


def test_learning_rate_accessors():
    tm = TargetVAE(ModelConfig.from_json(_model_config().to_json()),
                   device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    state = create_train_state(tm, LR, None)
    assert get_learning_rate(state) == pytest.approx(LR)
    assert get_learning_rate(set_learning_rate(state, 5e-5)) == 5e-5
    assert {g["lr"] for g in state.optimizer.param_groups} == {5e-5}
    # every parameter is trained, the Fourier buffers are not
    trained = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert trained == {id(p) for p in tm.parameters()}


def test_train_step_matches_jax_trainer(pair, zero_noise):
    """One train_step against the JAX Trainer._train_step, no noise. The
    metrics agree to rtol 2e-4 (the forward's tolerance). Adam's first step
    moves a weight by lr * g / (|g| + eps), about lr * sign(g). Where
    |g| > 1e-5 the updated params agree to atol 2e-5 (a tenth of lr) and each
    weight moved by lr to 1 %; where the gradient is rounding noise (the
    attention bias, see _assert_grads_close) its sign is not determined, so
    there only Adam's bound holds: no weight moves by more than lr."""
    jm, jp, images = pair
    y = images[:4]
    jtr = JaxTrainer(jm, jcfg.TrainConfig(learning_rate=LR))
    jstate = jax_train_state(jax.tree.map(jnp.asarray, jp), LR,
                             jax.random.key(2))
    jstate, jm_ = jtr._train_step(jstate, jnp.asarray(y))
    tm = _port_model(jm, jp)
    grads = _port_grads(_port_model(jm, jp), y)
    tr = Trainer(tm, TrainConfig(learning_rate=LR))
    state = create_train_state(tm, LR, None)
    state, m = tr.train_step(state, y)
    assert state.step == 1
    np.testing.assert_allclose(m.numpy(), np.asarray(jm_), rtol=2e-4)
    got = params_to_jax(tm.params())
    for (path, new), old, ref, g in zip(
            jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(jp),
            jax.tree.leaves(jax.tree.map(np.asarray, jstate.params)),
            jax.tree.leaves(_with_fourier(grads, jp))):
        big = np.abs(g) > 1e-5
        np.testing.assert_allclose(new[big], ref[big], rtol=0, atol=2e-5,
                                   err_msg=str(path))
        np.testing.assert_allclose(np.abs(new - old)[big], LR, rtol=1e-2,
                                   err_msg=str(path))
        assert np.abs(new - old).max() <= LR * (1 + 1e-3), path


def _with_fourier(grads, jp):
    """grads with zero Fourier entries, in the JAX pytree's leaf order."""
    out = {"encoder": grads["encoder"], "generator": dict(grads["generator"])}
    out["generator"]["fourier"] = jax.tree.map(np.zeros_like,
                                               jp["generator"]["fourier"])
    return out


def test_bf16_tier_gradients_track_f32_tier(pair):
    """On the CPU the bf16 tier runs the kernels' plain versions through the
    same autograd Functions the card uses; hidden 32 is no width of the
    pose kernels, so its decoder runs the XLA bf16 recipe, as on the card.
    Its gradients are finite and track the float32 tier's per parameter
    leaf. At this size (hidden 32, F 64, six images) bf16 operands move the
    decoder's leaves by up to 0.073 relative L2 (0.11 through K7/K8's plain
    versions), so the bound is the one the JAX package holds its
    pose decoder's bf16 gradients to against float32: 0.15 for the
    parameters, 0.2 for theta (tests/test_kernels.py:175-181), which here
    reaches the theta heads (conv_r)."""
    jm, jp, images = pair
    g32 = _port_grads(_port_model(jm, jp), images)
    g16 = _port_grads(_port_model(jm, jp), images, torch.bfloat16)
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(g16))
    _assert_grads_close(g16, g32, 0.15, tol_theta=0.2)


def test_bf16_encoder_past_the_kernels_widths_tracks_jax():
    """At K = 160, a width the encoder kernels do not take, the bf16 tier
    runs the JAX package's XLA bf16 recipe in plain PyTorch, chosen from the
    config before any launch: its heads track the JAX package's bf16 path
    on the CPU (encoder_apply in bf16: the conv in bf16, the rest in
    float32), which the recipe's bf16 h1, W2, h2 and Wh move by up to
    4.4e-3 relative L2 here (theta's log-std): within 1e-2. The bf16 ELBO
    trains: its gradients are finite and track the float32 tier's within
    the bf16 tier's bounds (0.15, the theta heads 0.2)."""
    jc = _model_config()
    jc = jcfg.ModelConfig(generator=jc.generator, likelihood=jc.likelihood,
                          encoder=jcfg.EncoderConfig(
                              **{**jc.encoder.__dict__, "kernels_num": 160}))
    jm = JaxTargetVAE(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    y = np.random.default_rng(0).uniform(0, 1, (3, 14, 14, 1)).astype(
        np.float32)
    tm = _port_model(jm, jp)
    assert not any(port_enc.encoder_kernel_supported(tm.cfg.encoder, tier,
                                                     grad)
                   for tier in ("conv", "patch") for grad in (False, True))
    ref = jax_enc.encoder_apply(jax.tree.map(jnp.asarray, jp["encoder"]),
                                jc.encoder, jnp.asarray(y), None,
                                compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = port_enc.encoder_apply(tm.params()["encoder"], tm.cfg.encoder,
                                     torch.from_numpy(y), None,
                                     torch.bfloat16)
    for name in ("attn", "theta_mu", "theta_logstd", "z_mu", "z_logstd"):
        assert _rel(got[name].numpy(), np.asarray(ref[name])) < 1e-2, name
    g32 = _port_grads(_port_model(jm, jp), y)
    g16 = _port_grads(_port_model(jm, jp), y, torch.bfloat16)
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(g16))
    _assert_grads_close(g16, g32, 0.15, tol_theta=0.2)


# (K, tier, grad, kernels): K1 takes K % 16 == 0 up to 128, K2, K11 and
# K12 K in 16, 32, 64, 128
ENCODER_ROUTES = [
    (64, "conv", False, True), (64, "conv", True, True),
    (64, "patch", False, True), (64, "patch", True, True),
    (48, "conv", False, True), (48, "conv", True, False),
    (48, "patch", False, False), (112, "conv", False, True),
    (160, "conv", False, False), (160, "patch", True, False)]


@pytest.mark.parametrize("K, tier, grad, kernels", ENCODER_ROUTES)
def test_encoder_routes_to_the_kernels_where_they_take_the_shape(
        monkeypatch, K, tier, grad, kernels):
    """The bf16 encoder runs a tier's kernels wherever they take the
    config's widths in the direction asked, and the plain recipe only
    where they do not: conv-tier eval and embed at K = 48 keep K1, its
    training (K2 takes no K = 48) runs plain. Read from the route the
    model takes on the CPU: the recipe is the only caller of
    lift_act_mix_heads_plain outside the kernels' wrappers."""
    cfg = EncoderConfig(image_dim=14, z_dim=2, kernels_num=K, kernels_size=8,
                        padding=3, groupconv=4)
    assert port_enc.encoder_kernel_supported(cfg, tier, grad) is kernels
    monkeypatch.setenv("TARGETVAE_ENCODER_TIER", tier)
    calls = []
    real = port_enc._mode_c_bf16_recipe
    monkeypatch.setattr(port_enc, "_mode_c_bf16_recipe",
                        lambda *a: calls.append(1) or real(*a))
    params = port_enc.encoder_init(torch.Generator().manual_seed(0), cfg)
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(grad)
    y = torch.rand((2, 14, 14, 1), generator=torch.Generator().manual_seed(1))
    heads = port_enc.encoder_heads(params, cfg, y, torch.bfloat16)
    assert heads.shape == (2, 13, 13, 4, 7)
    assert bool(calls) is not kernels


def test_entry_points_default_to_cuda():
    """TargetVAE and Trainer run on cuda:0 unless told otherwise; without a
    CUDA device they raise rather than fall back to the CPU. A dp = 2
    Trainer told device='cpu' runs on the CPU, on 2 gloo ranks."""
    cfg = ModelConfig.from_json(_model_config().to_json())
    if torch.cuda.is_available():
        assert TargetVAE(cfg).device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TargetVAE(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainConfig())
    assert Trainer(cfg, TrainConfig(), device="cpu").model.device.type == "cpu"
    import torch_port_ranks
    from targetvae_tpu_torch.parallel.distributed import run_local
    y = np.random.default_rng(0).uniform(0, 1, (4, 14, 14, 1)).astype(
        np.float32)
    ranks = run_local(torch_port_ranks.dp_trainer_step, 2, backend="gloo",
                      timeout=300, args=(cfg.to_json(), y))
    for r in ranks:
        assert r["device"] == "cpu" and r["step"] == 1
        np.testing.assert_array_equal(r["metrics"], ranks[0]["metrics"])
        assert np.isfinite(r["metrics"]).all()


def test_trainer_accepts_any_name_of_the_model_device():
    """A bare "cuda" names cuda:0, so Trainer(TargetVAE(cfg), ...,
    device="cuda") finds the model on its device; a model on another device
    than the one named is refused."""
    from targetvae_tpu_torch.models.targetvae import resolve_device
    assert (resolve_device("cuda") == resolve_device("cuda:0")
            == resolve_device(torch.device("cuda")) == torch.device("cuda", 0))
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    cfg = ModelConfig.from_json(_model_config().to_json())
    model = TargetVAE(cfg, device="cpu")
    for name in ("cpu", torch.device("cpu")):
        assert Trainer(model, TrainConfig(), device=name).model is model
    with pytest.raises(ValueError, match="not cuda"):
        Trainer(model, TrainConfig(), device="cuda")
