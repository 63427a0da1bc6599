"""targetvae_tpu_torch ops against the JAX package's, on numpy inputs from a seed.

Both sides get the same numpy arrays; the float32 results must agree to
float32 rounding (tolerances state the reason where they are not exact).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import targetvae_tpu.ops.coords as jc
import targetvae_tpu.ops.fourier as jf
import targetvae_tpu.ops.groupconv as jg
import targetvae_tpu.ops.kl as jkl
import targetvae_tpu.ops.rotate as jr
from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.utils import config as jcfg

import targetvae_tpu_torch.ops.coords as tc
import targetvae_tpu_torch.ops.fourier as tf
import targetvae_tpu_torch.ops.groupconv as tg
import targetvae_tpu_torch.ops.kl as tkl
import targetvae_tpu_torch.ops.rotate as tr
from targetvae_tpu_torch import TargetVAE
from targetvae_tpu_torch.ops.gumbel import gumbel_softmax
from targetvae_tpu_torch.utils import config as tcfg
from targetvae_tpu_torch.utils.jax_params import params_from_jax, params_to_jax


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("k,R", [(8, 4), (7, 8), (28, 8), (5, 16)])
def test_rotation_tables_and_filter_bank(k, R):
    ji, jw = jr.rotation_tables(k, R)
    ti, tw = tr.rotation_tables(k, R)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jw, tw)
    w = np.random.default_rng(0).normal(size=(3, 2, 1, k, k)).astype(np.float32)
    ref = np.asarray(jr.rotate_filter_bank(jnp.asarray(w), R))
    got = tr.rotate_filter_bank(_t(w), R).numpy()
    # 4-term bilinear sums in float32; einsum order may differ
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [14, 50, 51])
def test_image_grid(d):
    np.testing.assert_array_equal(tc.image_grid(d), jc.image_grid(d))


@pytest.mark.parametrize("ad,d", [(13, 14), (12, 14), (39, 50), (40, 50)])
def test_attention_grid_odd_and_even(ad, d):
    np.testing.assert_array_equal(tc.attention_grid(ad, d),
                                  jc.attention_grid(ad, d))


def test_transform_coords():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (30, 2)).astype(np.float32)
    dx = rng.normal(size=(4, 2)).astype(np.float32) * 0.2
    th = rng.normal(size=(4,)).astype(np.float32)
    ref = np.asarray(jc.transform_coords(jnp.asarray(x), jnp.asarray(dx),
                                         jnp.asarray(th)))
    got = tc.transform_coords(_t(x), _t(dx), _t(th)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_guarded_moments_and_normal_kl():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(5, 12)).astype(np.float32)
    q[:, ::3] = -200.0                     # exp underflows to exactly 0 in f32
    mu = rng.normal(size=(5, 12)).astype(np.float32)
    std = rng.uniform(0.1, 2, (5, 12)).astype(np.float32)
    jm, js = jkl.guarded_moments(jnp.asarray(q), jnp.asarray(mu),
                                 jnp.asarray(std))
    tm, ts = tkl.guarded_moments(_t(q), _t(mu), _t(std))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tm.numpy()[:, ::3] == 0).all() and (ts.numpy()[:, ::3] == 1).all()
    ref = np.asarray(jkl.normal_kl(jm, js, 0.3, 0.7))
    got = tkl.normal_kl(tm, ts, 0.3, 0.7).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("R,pad", [(4, 2), (8, 0)])
def test_lifted_conv2d(R, pad):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 11, 11, 1)).astype(np.float32)
    w = rng.normal(size=(6, 1, 1, 5, 5)).astype(np.float32) * 0.2
    b = rng.normal(size=(6,)).astype(np.float32)
    ref = np.asarray(jg.lifted_conv2d(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), R=R, padding=pad))
    got = tg.lifted_conv2d(_t(x), _t(w), _t(b), R=R, padding=pad).numpy()
    assert got.shape == ref.shape
    # 25-term f32 conv sums; the two backends order them differently
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_fourier_apply_and_gumbel_with_explicit_noise():
    rng = np.random.default_rng(4)
    p = {"w": rng.normal(size=(2, 16)).astype(np.float32),
         "b": rng.uniform(0, 6.28, (16,)).astype(np.float32)}
    x = rng.uniform(-1, 1, (3, 7, 2)).astype(np.float32)
    ref = np.asarray(jf.fourier_apply({k: jnp.asarray(v) for k, v in p.items()},
                                      jnp.asarray(x), 0.15))
    got = tf.fourier_apply({k: _t(v) for k, v in p.items()}, _t(x), 0.15)
    # cos of phases up to ~40 rad: f32 argument rounding
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)
    logits = rng.normal(size=(3, 10)).astype(np.float32)
    noise = rng.gumbel(size=(3, 10)).astype(np.float32)
    a = gumbel_softmax(_t(logits), noise=_t(noise)).numpy()
    np.testing.assert_allclose(
        a, np.asarray(jax.nn.softmax(jnp.asarray(logits + noise), axis=-1)),
        rtol=1e-6, atol=1e-7)
    g = gumbel_softmax(_t(logits), torch.Generator().manual_seed(0))
    assert torch.allclose(g.sum(-1), torch.ones(3))


def _small_cfgs():
    kw = dict(
        generator=dict(z_dim=2, hidden_dim=32, num_layers=3,
                       fourier_expansion=True, fourier_sigma=2 / 13,
                       embedding_dim=64),
        encoder=dict(image_dim=14, kernels_num=16, kernels_size=8, padding=3,
                     groupconv=4),
        likelihood=dict(kind="bernoulli"))
    j = jcfg.ModelConfig(jcfg.GeneratorConfig(**kw["generator"]),
                         jcfg.EncoderConfig(**kw["encoder"]),
                         jcfg.LikelihoodConfig(**kw["likelihood"]))
    return j, tcfg.ModelConfig.from_json(j.to_json())


def test_config_json_round_trips_between_packages():
    j, t = _small_cfgs()
    assert t.to_json() == j.to_json()
    assert jcfg.ModelConfig.from_json(t.to_json()) == j
    assert t.encoder.mode == "C" and t.encoder.rot_refinement


def test_params_from_jax_round_trip():
    jcfg_, tcfg_ = _small_cfgs()
    jp = jax.tree.map(np.asarray, JaxTargetVAE(jcfg_).init(jax.random.key(0)))
    tp = params_from_jax(jp)
    back = params_to_jax(tp)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jp))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the module installs them, with the Fourier pair as buffers
    m = TargetVAE(tcfg_, device="cpu")
    m.load_params(tp)
    assert {n for n, _ in m.named_buffers()} == {
        "spatial_generator.fourier.w", "spatial_generator.fourier.b"}
    np.testing.assert_array_equal(
        params_to_jax(m.params())["encoder"]["conv1"]["w"],
        jp["encoder"]["conv1"]["w"])
    n_jax = sum(a.size for a in jax.tree.leaves(jp))
    assert (sum(p.numel() for p in m.parameters())
            + sum(b.numel() for b in m.buffers())) == n_jax


def test_init_shapes_match_jax():
    jcfg_, tcfg_ = _small_cfgs()
    jp = JaxTargetVAE(jcfg_).init(jax.random.key(0))
    tp = TargetVAE(tcfg_, device="cpu").init(torch.Generator().manual_seed(0))
    jshape = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshape = jax.tree.map(lambda a: tuple(a.shape), params_to_jax(tp))
    assert jshape == tshape
    # U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for conv1: fan_in = 1 * 8 * 8
    w = tp["encoder"]["conv1"]["w"]
    assert float(w.abs().max()) <= 1 / 8 and float(w.std()) > 0.05
