"""The port's decoder at arbitrary coordinates in bf16 (K9, K10, and the
XLA-recipe tier for the generators they do not cover) on the CPU against the
JAX package: the kernel's plain versions against fused_decoder_mlp in
interpret mode, TargetVAE.decode in bf16, and a bf16 ELBO whose generator
neither K9 nor the pose decoder covers.

Inputs are made with numpy from a seed and handed to both sides. Every
tolerance is stated where it is used, with its reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import targetvae_tpu.kernels.lifted_encoder as LE
import targetvae_tpu.models.encoders as EN
from targetvae_tpu.kernels.decoder_mlp import fused_decoder_mlp as jax_mlp
from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
from targetvae_tpu.losses.elbo import reconstruct_log_prob as jax_recon
from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.utils import config as jcfg

import targetvae_tpu_torch.kernels as kernels
import targetvae_tpu_torch.models.generator as tgen
from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.kernels.decoder_mlp import (
    _DecoderMLP, decoder_kernel_supported, decoder_mlp_fwd)
from targetvae_tpu_torch.kernels.decoder_pose import pose_decoder_supported
from targetvae_tpu_torch.losses.elbo import compute_elbo, reconstruct_log_prob
from targetvae_tpu_torch.ops.coords import transform_coords
from targetvae_tpu_torch.utils.jax_params import params_from_jax


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _mlp_inputs(B=3, N=70, F=256, H=128, n_out=2):
    """tests/test_kernels.py:44's shapes and scales: N = 70 is no multiple
    of the JAX kernel's 64-row tile, so its masked tail rows are exercised."""
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(x=f(B, N, 2), hz=f(B, H), wf=f(2, F),
                bf=(rng.uniform(size=F) * 6).astype(np.float32),
                w1=f(F, H) * 0.05, b1=f(H) * 0.1, w2=f(H, H) * 0.08,
                b2=f(H) * 0.1, w3=f(H, n_out) * 0.1, b3=f(n_out) * 0.1)


@pytest.mark.parametrize("act", ["leakyrelu", "tanh"])
@pytest.mark.parametrize("N", [70, 135])
def test_decoder_mlp_plain_matches_jax_kernel(act, N):
    """K9's and K10's plain versions (through the autograd Function on the
    CPU) against fused_decoder_mlp in interpret mode, forward and gradient
    in x, hz and every weight, with each activation and two pixel counts
    that leave a ragged tail in the JAX kernel's 64-row tile (70 = 64 + 6,
    135 = 2 x 64 + 7). Both round the features and each h to bf16 at the
    same points; their cos and f32 sums may differ by an ulp, which can
    move a bf16 value by one step: the output within 1e-2 absolute (K7's
    bound), each gradient within 1e-2 relative L2 (K8's against JAX,
    tests/test_torch_port_train.py)."""
    a = _mlp_inputs(N=N)
    g = np.random.default_rng(12).normal(size=(3, N, 2)).astype(np.float32)
    order = ("x", "hz", "w1", "b1", "w2", "b2", "w3", "b3")

    def jfn(x, hz, w1, b1, w2, b2, w3, b3):
        return jax_mlp(x, hz, jnp.asarray(a["wf"]), jnp.asarray(a["bf"]), w1,
                       b1, w2, b2, w3, b3, act, 64, True)

    ref, vjp = jax.vjp(jfn, *(jnp.asarray(a[n]) for n in order))
    ref_g = vjp(jnp.asarray(g))
    t = {n: torch.from_numpy(v).requires_grad_() for n, v in a.items()}
    wh, bh = t["w2"][None], t["b2"][None]
    y = _DecoderMLP.apply(t["x"], t["wf"], t["bf"], t["hz"], t["w1"], t["b1"],
                          wh, bh, t["w3"], t["b3"], act)
    assert y.shape == (3, N, 2)
    assert float(np.abs(y.detach().numpy() - np.asarray(ref)).max()) < 1e-2
    y.backward(torch.from_numpy(g))
    for name, r in zip(order, ref_g):
        assert _rel(t[name].grad.numpy(), r) < 1e-2, (name, _rel(
            t[name].grad.numpy(), r))
    assert t["wf"].grad is None and t["bf"].grad is None
    # the wrapper on CPU tensors is the plain version, and counts nothing
    kernels.reset_launch_counts()
    with torch.no_grad():
        again = decoder_mlp_fwd(t["x"], t["wf"], t["bf"], t["hz"], t["w1"],
                                t["b1"], wh, bh, t["w3"], t["b3"],
                                act_kind=act)
    assert torch.equal(again, y.detach())
    assert kernels.launch_counts()["decoder_mlp_fwd"] == 0


def _model_config(**gen):
    """tests/test_torch_port_slice.py's small config, with generator
    options."""
    g = dict(z_dim=2, hidden_dim=32, n_out=1, num_layers=2,
             fourier_expansion=True, fourier_sigma=2.0 / 13, embedding_dim=64)
    g.update(gen)
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(**g),
        encoder=jcfg.EncoderConfig(image_dim=14, z_dim=2, kernels_num=16,
                                   kernels_size=8, padding=3, groupconv=4),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


GENERATORS = {
    "kernel": {"hidden_dim": 64},                   # K9's, at its width
    "no_fourier": {"fourier_expansion": False},     # neither K9 nor pose
    "resid": {"resid": True, "num_layers": 3},      # neither K9 nor pose
}


def _pair(gen):
    jc = _model_config(**GENERATORS[gen])
    jm = JaxTargetVAE(jc)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.load_params(params_from_jax(jp))
    return jm, jp, tm


def _pose(B=3):
    rng = np.random.default_rng(13)
    return (rng.normal(size=(B,)).astype(np.float32),
            (rng.normal(size=(B, 2)) * 0.2).astype(np.float32),
            rng.normal(size=(B, 2)).astype(np.float32))


@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_bf16_decode_matches_jax(gen):
    """TargetVAE.decode in bf16 at posed coordinates against the JAX
    package's bf16 decode on the CPU (its XLA recipe: features in float32
    cast to bf16, bf16 operands, float32 accumulation). On the generators
    K9 does not cover the port runs the same recipe: 1e-5 absolute (f32 sum
    order). On K9's it runs K9's plain version, which rounds each h to bf16
    as the recipe does but forms hz = z W_latent in float32 where the recipe
    rounds z and W_latent to bf16: 1e-2 absolute (K7's bound). Either way
    the bf16 decode tracks the float32 decode to 2e-2 of its scale."""
    jm, jp, tm = _pair(gen)
    covered = decoder_kernel_supported(tm.cfg.generator)
    assert covered == (gen == "kernel")
    assert not pose_decoder_supported(tm.cfg.generator) or covered
    theta, dx, z = _pose()
    x = transform_coords(tm.base_grid(), torch.from_numpy(dx),
                         torch.from_numpy(theta))
    ref = np.asarray(jm.decode(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(x.numpy()), jnp.asarray(z),
                               compute_dtype=jnp.bfloat16))
    with torch.inference_mode():
        got = tm.decode(tm.params(), x, torch.from_numpy(z), torch.bfloat16)
        f32 = tm.decode(tm.params(), x, torch.from_numpy(z))
    assert got.shape == ref.shape == (3, 14 * 14, 1)
    tol = 1e-2 if covered else 1e-5
    assert float(np.abs(got.numpy() - ref).max()) < tol
    scale = float(f32.abs().max())
    assert float((got - f32).abs().max()) < 2e-2 * scale


@pytest.mark.parametrize("gen", ["no_fourier", "resid"])
def test_bf16_elbo_uncovered_generator_matches_jax(gen, monkeypatch):
    """The bf16 ELBO of a generator neither K9 nor the pose kernel covers
    (it raised before this tier was ported) against the JAX package's bf16
    ELBO on the CPU, no noise. The reconstruction term alone at the same
    (theta, dx, z): both run the XLA bf16 recipe, 1e-5 relative. The whole
    ELBO with the patch encoder on both sides (the JAX kernel in interpret
    mode, tests/test_torch_port_patch_encoder.py), so that the two encoders
    round alike: 1e-4 relative. Its gradient is finite in every leaf."""
    jm, jp, tm = _pair(gen)
    theta, dx, z = _pose()
    y = np.random.default_rng(14).uniform(size=(3, 14, 14, 1)).astype(
        np.float32)
    ref = float(jnp.mean(jax_recon(
        jax.tree.map(jnp.asarray, jp), jm.cfg, jm.base_grid(), jnp.asarray(y),
        jnp.asarray(theta), jnp.asarray(dx), jnp.asarray(z),
        compute_dtype=jnp.bfloat16)))
    with torch.inference_mode():
        got = float(reconstruct_log_prob(
            tm.params(), tm.cfg, tm.base_grid(), torch.from_numpy(y),
            torch.from_numpy(theta), torch.from_numpy(dx),
            torch.from_numpy(z), torch.bfloat16).mean())
    assert abs(got - ref) < 1e-5 * abs(ref), (got, ref)

    monkeypatch.setenv("TARGETVAE_ENCODER_TIER", "patch")
    orig = LE.fused_lifted_encoder
    monkeypatch.setattr(LE, "fused_lifted_encoder",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(EN, "_use_encoder_kernel",
                        lambda cfg, dt: dt == jnp.bfloat16)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(EN, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))
    ref = float(jax_compute_elbo(jax.tree.map(jnp.asarray, jp), jm.cfg,
                                 jm.base_grid(), jnp.asarray(y),
                                 jax.random.key(1),
                                 compute_dtype=jnp.bfloat16)[0])
    elbo = compute_elbo(tm.params(), tm.cfg, tm.base_grid(),
                        torch.from_numpy(y), None, torch.bfloat16)[0]
    assert abs(float(elbo.detach()) - ref) < 1e-4 * abs(ref)
    (-elbo).backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


def test_generator_bf16_tier_dispatch(monkeypatch):
    """bf16 generator_apply takes K9 exactly where the JAX package takes its
    kernel (a covered configuration and a latent) and the XLA recipe
    everywhere else; nothing raises."""
    calls = []
    orig = tgen.fused_decoder_mlp
    monkeypatch.setattr(tgen, "fused_decoder_mlp",
                        lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    x = torch.rand(2, 5, 2)
    for gen in sorted(GENERATORS):
        _, _, tm = _pair(gen)
        p, cfg = tm.params(), tm.cfg.generator
        calls.clear()
        with torch.inference_mode():
            a = tgen.generator_apply(p["generator"], cfg, x, torch.rand(2, 2),
                                     torch.bfloat16)
            b = tgen.generator_apply(p["generator"], cfg, x, None,
                                     torch.bfloat16)
        assert a.shape == b.shape == (2, 5, 1)
        assert calls == ([1] if gen == "kernel" else []), gen
