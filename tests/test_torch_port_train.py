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
from targetvae_tpu_torch.losses.elbo import compute_elbo
from targetvae_tpu_torch.train import (
    Trainer, create_train_state, get_learning_rate, make_optimizer,
    set_learning_rate)
from targetvae_tpu_torch.utils.config import GeneratorConfig, TrainConfig
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
    """tests/test_kernels.py:218's shapes."""
    rng = np.random.default_rng(1)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    p = f(R * M)
    p_tr = (p - np.log(np.exp(p - p.max()).sum()) - p.max()).reshape(R, M)
    return (f(B, R, M) * 2, f(B, R, M), f(B, R, M) * 0.3, f(B, zd, R, M),
            f(B, zd, R, M) * 0.3, p_tr.astype(np.float32), f(M, 2),
            np.asarray([0, np.pi / 2, np.pi, -np.pi / 2], np.float32),
            float(np.pi / 4))


_POST_KEYS = ("z_mu_e", "z_std_e", "theta_mu_e", "theta_std_e", "dx", "kl")


def _packed_cotangent(g, zd):
    return {"z_mu_e": g[:, :zd], "z_std_e": g[:, zd:2 * zd],
            "theta_mu_e": g[:, 2 * zd], "theta_std_e": g[:, 2 * zd + 1],
            "dx": g[:, 2 * zd + 2:2 * zd + 4], "kl": g[:, 2 * zd + 4]}


def test_posterior_backward_plain_matches_jax_kernel():
    """K4, deterministic, against the JAX kernel's hand-derived VJP: both
    float32 with the same formulas, so 1e-4 relative per element (floored
    at 1)."""
    args = _posterior_inputs()
    g = np.random.default_rng(2).normal(size=(3, 9)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: jax_posterior(jax.random.key(9), *a, *map(jnp.asarray,
                                                             args[5:8]),
                                 args[8], deterministic=True, interpret=True),
        *map(jnp.asarray, args[:5]))
    ref = vjp({k: jnp.asarray(v) for k, v in _packed_cotangent(g, 2).items()})
    got = posterior_bwd_plain(torch.from_numpy(g),
                              *map(torch.from_numpy, args[:8]), args[8])
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert (np.abs(a.numpy() - b) / np.maximum(np.abs(b), 1.0)).max() < 1e-4


def test_posterior_sampled_cpu_backward_is_autograd_of_plain():
    """The CPU Function's sampled backward regenerates the forward's noise
    from the seed: it equals torch.autograd of posterior_plain fed the same
    per_image_gumbel noise (float32, two formulas of one derivative:
    1e-5 relative per element, floored at 1)."""
    args = _posterior_inputs()
    g = torch.from_numpy(
        np.random.default_rng(3).normal(size=(3, 9)).astype(np.float32))
    cot = _packed_cotangent(g, 2)
    consts = [torch.from_numpy(a) for a in args[5:8]] + [args[8]]

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
        out = fn(leaves)
        sum((out[k] * cot[k]).sum() for k in _POST_KEYS).backward()
        return [t.grad for t in leaves]

    got = grads(lambda t: fused_posterior(17, *t, *consts))
    noise = per_image_gumbel(17, args[0].shape)
    ref = grads(lambda t: posterior_plain(*t, *consts, noise=noise))
    for a, b in zip(got, ref):
        assert float(((a - b).abs() / b.abs().clamp(min=1.0)).max()) < 1e-5


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
    same autograd Functions the card uses. Its gradients are finite and
    track the float32 tier's per parameter leaf. At this size (hidden 32,
    F 64, six images) bf16 operands move the decoder's leaves by up to
    0.11 relative L2, so the bound is the one the JAX package holds its
    pose decoder's bf16 gradients to against float32: 0.15 for the
    parameters, 0.2 for theta (tests/test_kernels.py:175-181), which here
    reaches the theta heads (conv_r)."""
    jm, jp, images = pair
    g32 = _port_grads(_port_model(jm, jp), images)
    g16 = _port_grads(_port_model(jm, jp), images, torch.bfloat16)
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(g16))
    _assert_grads_close(g16, g32, 0.15, tol_theta=0.2)


def test_entry_points_default_to_cuda():
    """TargetVAE and Trainer run on cuda:0 unless told otherwise; without a
    CUDA device they raise rather than fall back to the CPU."""
    cfg = ModelConfig.from_json(_model_config().to_json())
    if torch.cuda.is_available():
        assert TargetVAE(cfg).device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TargetVAE(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainConfig())
    assert Trainer(cfg, TrainConfig(), device="cpu").model.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="dp"):
        Trainer(cfg, TrainConfig(dp=2), device="cpu")


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
