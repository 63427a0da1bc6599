"""The port's inference modes A and B against the JAX package: the encoders,
the plain versions of K1/K2 at R = 1 with a rectangular mixing and of K3/K4
at R = 1 against the Pallas kernels (interpret mode), the deterministic ELBO
and its per-leaf gradients, embed, the parameter and checkpoint round trips
and the train CLI; plus kernel-against-plain cases that need a CUDA device
(they skip on a machine without one).

Tolerances: float32 against float32, rtol 2e-4 / atol 1e-4 (the JAX
comparisons of tests/test_torch_port_slice.py: the two sides sum the
convolutions and matmuls in other orders); the bf16 routes 1e-2 relative
(bf16 operands rounded at the same points, a value one bf16 step apart where
the two f32 sums straddle a rounding boundary); gradients 2e-4 relative L2
per leaf in float32 (tests/test_torch_port_train.py).

The CUDA cases need no JAX, so on a GPU machine without it they run as
    python -m pytest --noconftest tests/test_torch_port_modes.py -k cuda
"""

import os
import types

import numpy as np
import pytest
import torch

import targetvae_tpu_torch.kernels as kernels
from targetvae_tpu_torch import TargetVAE
from targetvae_tpu_torch.kernels.mix_heads import (
    fused_mix_heads_r1, lift_act_mix_heads_bwd_plain,
    FWD_TILE_POS, R1_RESIDENT_KI, R1_TILE, lift_act_mix_heads_plain,
    mix_heads_r1_bwd, mix_heads_r1_fwd, r1_channel_schedule,
    r1_fwd_schedule)
from targetvae_tpu_torch.kernels.posterior import (
    fused_posterior, k3_schedule, k4_schedule, philox_gumbel,
    posterior_bwd, posterior_bwd_plain, posterior_fwd, posterior_plain)
from targetvae_tpu_torch.losses.elbo import (_translation_log_prior,
                                             compute_elbo)
from targetvae_tpu_torch.models import encoders as port_enc
from targetvae_tpu_torch.ops.coords import attention_grid
from targetvae_tpu_torch.utils.config import ModelConfig, TrainConfig
from targetvae_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

RTOL, ATOL = 2e-4, 1e-4
D_IMG = 14
MODES = {"A": ("unimodal", "unimodal", 4), "B0": ("attention", "unimodal", 0),
         "B8": ("attention", "unimodal", 8)}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported only where a test asks for it."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import targetvae_tpu.models.encoders as enc
    from targetvae_tpu.kernels.mix_heads import fused_lift_act_mix_heads
    from targetvae_tpu.kernels.posterior import fused_posterior as post
    from targetvae_tpu.losses.elbo import compute_elbo as elbo
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.train import checkpoint
    from targetvae_tpu.utils import config as jcfg
    return types.SimpleNamespace(jax=jax, jnp=jnp, enc=enc, elbo=elbo,
                                 mix=fused_lift_act_mix_heads, post=post,
                                 TargetVAE=JaxTargetVAE, cfg=jcfg,
                                 checkpoint=checkpoint)


@pytest.fixture
def cuda():
    """The CUDA device; decided inside the test, so every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


def _config(jx, mode, resid=False, z_dim=2):
    t_inf, r_inf, g = MODES[mode]
    c = jx.cfg
    return c.ModelConfig(
        generator=c.GeneratorConfig(z_dim=z_dim, hidden_dim=32, n_out=1,
                                    num_layers=2, fourier_expansion=True,
                                    fourier_sigma=2.0 / (D_IMG - 1),
                                    embedding_dim=64),
        encoder=c.EncoderConfig(t_inf=t_inf, r_inf=r_inf, image_dim=D_IMG,
                                z_dim=z_dim, kernels_num=16, kernels_size=8,
                                padding=3, groupconv=g, num_layers=2,
                                resid=resid),
        likelihood=c.LikelihoodConfig(kind="bernoulli"))


def _pair(jx, mode, resid=False):
    jc = _config(jx, mode, resid)
    jm = jx.TargetVAE(jc)
    jp = jx.jax.tree.map(np.asarray, jm.init(jx.jax.random.key(0)))
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.load_params(params_from_jax(jp))
    return jm, jp, tm


def _images(n=6, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, D_IMG, D_IMG, 1)).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture
def zero_noise(jx, monkeypatch):
    """The JAX side without sampling noise, as tests/test_elbo.py does: the
    reparameterisation normals are zero and the Gumbel sample is the plain
    softmax. The port's counterpart is generator=None."""
    monkeypatch.setattr(jx.jax.random, "normal",
                        lambda key, shape=(), dtype=jx.jnp.float32:
                        jx.jnp.zeros(shape, dtype))
    monkeypatch.setattr(jx.enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jx.jax.nn.softmax(logits, axis=axis))


# ---- the encoders ----

@pytest.mark.parametrize("resid", [False, True])
def test_mode_a_encoder_matches_jax(jx, resid):
    jm, jp, tm = _pair(jx, "A", resid)
    y = _images()
    ref = jx.enc.encoder_apply(jp["encoder"], jm.cfg.encoder,
                               jx.jnp.asarray(y), None)
    got = port_enc.encoder_apply(tm.params()["encoder"], tm.cfg.encoder,
                                 torch.from_numpy(y))
    assert set(got) == set(ref) == {"z_mu", "z_logstd"}
    for name in ref:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(ref[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("mode", ["B0", "B8"])
def test_mode_b_encoder_f32_matches_jax(jx, mode):
    jm, jp, tm = _pair(jx, mode)
    y = _images()
    ref = jx.enc.encoder_apply(jp["encoder"], jm.cfg.encoder,
                               jx.jnp.asarray(y), None)
    with torch.inference_mode():
        got = port_enc.encoder_apply(tm.params()["encoder"], tm.cfg.encoder,
                                     torch.from_numpy(y))
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("mode", ["B0", "B8"])
def test_mode_b_kernel_route_matches_jax_fast_tier(jx, mode):
    """The port's mode-B kernel route (bf16 lift conv, the fold, K1 at R =
    1; on the CPU K1's plain version) against the JAX package's fast tier
    with its kernel off (_mode_b_fast(..., allow_kernels=False)): the same
    bf16 rounding points, 1e-2 relative L2 a head."""
    jm, jp, tm = _pair(jx, mode)
    y = _images()
    ref = jx.enc._mode_b_fast(jp["encoder"], jm.cfg.encoder,
                              jx.jnp.asarray(y), allow_kernels=False)
    with torch.inference_mode():
        out = port_enc._mode_b_kernel_tier(tm.params()["encoder"],
                                           tm.cfg.encoder,
                                           torch.from_numpy(y))
        heads = out.reshape(6, 15, 15, -1)
    got = port_enc._split_heads(heads, 2)
    for g, r, name in zip(got, ref, ("attn", "theta_mu", "theta_logstd",
                                     "z_mu", "z_logstd")):
        assert g.shape == r.shape, name
        assert _rel(g.numpy(), np.asarray(r)) < 1e-2, name


def test_mode_b_fold_gradient_reaches_fc_r_and_conv2():
    """The fold is torch ops on the parameters: the kernel route's gradient
    reaches conv1, fc_r and conv2 (on the CPU through K1's plain version)."""
    cfg = ModelConfig.from_json(_config_json("B8"))
    tm = TargetVAE(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    heads = port_enc.encoder_heads(params["encoder"], cfg.encoder,
                                   torch.from_numpy(_images()),
                                   torch.bfloat16)
    heads.square().sum().backward()
    for name in ("conv1", "fc_r", "conv2", "conv_z"):
        for p in params["encoder"][name].values():
            assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


def test_mode_b_kernel_tier_raises_for_widths_k1_r1_does_not_take():
    """The bf16 tier runs mode B on K1/K2 at R = 1 only: widths they do not
    take (kernels_num outside 16/32/64/128, more than 16 heads) raise,
    with no plain fallback; the float32 tier runs them."""
    from targetvae_tpu_torch.utils.config import EncoderConfig
    y = torch.from_numpy(_images())
    for kw in ({"kernels_num": 24}, {"kernels_num": 16, "z_dim": 7}):
        cfg = EncoderConfig(t_inf="attention", r_inf="unimodal",
                            image_dim=D_IMG, kernels_size=8, padding=3,
                            groupconv=0, **kw)
        params = port_enc.encoder_init(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(ValueError, match="K1/K2 at R = 1"):
            port_enc.encoder_heads(params, cfg, y, torch.bfloat16)
        assert torch.isfinite(port_enc.encoder_heads(params, cfg, y)).all()


def _config_json(mode):
    t_inf, r_inf, g = MODES[mode]
    from targetvae_tpu_torch.utils.config import (EncoderConfig,
                                                  GeneratorConfig)
    return ModelConfig(
        GeneratorConfig(hidden_dim=32, fourier_expansion=True,
                        embedding_dim=64),
        EncoderConfig(t_inf=t_inf, r_inf=r_inf, image_dim=D_IMG,
                      kernels_num=16, kernels_size=8, padding=3,
                      groupconv=g)).to_json()


def test_mode_errors_match_jax(monkeypatch):
    """Bad groupconv values raise the JAX package's ValueErrors; mode B on
    the patch tier and SP for mode A raise NotImplementedError; SP for mode
    B, ported, wants its ranks."""
    from targetvae_tpu_torch.train import Trainer
    cfg = ModelConfig.from_json(_config_json("B0"))
    bad = ModelConfig.from_json(_config_json("B0").replace(
        '"groupconv": 0', '"groupconv": 3'))
    with pytest.raises(ValueError, match="groupconv must be 0, 4, 8 or 16"):
        TargetVAE(bad, "cpu").init(torch.Generator())
    tm = TargetVAE(cfg, "cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    monkeypatch.setenv("TARGETVAE_ENCODER_TIER", "patch")
    with pytest.raises(NotImplementedError, match="no mode-B route"):
        tm.embed(params, torch.from_numpy(_images(2)), torch.bfloat16)
    # mode A has no grid to shard; mode B's grid-sharded step is ported,
    # and then needs the process group of its 2 ranks
    for mode, error, match in (("A", NotImplementedError, "no grid"),
                               ("B0", RuntimeError, "process group")):
        with pytest.raises(error, match=match):
            Trainer(ModelConfig.from_json(_config_json(mode)),
                    TrainConfig(compute_dtype="bfloat16", tp=2, sp=True),
                    device="cpu")


# ---- K1/K2 and K3/K4 at R = 1: the plain versions against Pallas ----

def _r1_inputs(KI=64, K=16, D=7, N=90, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return (f(N, KI) * 0.5, f(KI) * 0.1, f(KI, K) * 0.05, f(K) * 0.1,
            f(K, D) * 0.1, f(D) * 0.1)


@pytest.mark.parametrize("KI, K, act", [(16, 16, "leakyrelu"),
                                        (64, 16, "tanh"),
                                        (128, 32, "leakyrelu"),
                                        (8, 16, "tanh"),
                                        (136, 32, "leakyrelu")])
def test_r1_mix_heads_plain_matches_pallas(jx, KI, K, act):
    """K1's and K2's plain versions at R = 1 with a rectangular (KI, K)
    mixing against fused_lift_act_mix_heads(..., R=1, interpret=True),
    forward and VJP: the same bf16 rounding points, float32 sums in other
    orders (forward 1e-4 abs; dpre1 one bf16 step, 1e-2 relative L2; the
    weight gradients 1e-3 relative L2)."""
    jnp = jx.jnp
    a = _r1_inputs(KI, K)
    a = (a[0].astype(jnp.bfloat16),) + a[1:]
    jargs = [jnp.asarray(x) for x in a]
    ref, vjp = jx.jax.vjp(lambda *p: jx.mix(*p, R=1, K=K, act_kind=act,
                                             interpret=True), *jargs)
    t = [torch.from_numpy(np.asarray(x, np.float32)) for x in a]
    t[0] = t[0].to(torch.bfloat16)
    got = lift_act_mix_heads_plain(*t, R=1, K=K, act_kind=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    g = np.random.default_rng(1).normal(size=got.shape).astype(np.float32)
    rg = vjp(jnp.asarray(g))
    tg = lift_act_mix_heads_bwd_plain(*t[:5], torch.from_numpy(g), R=1, K=K,
                                      act_kind=act)
    assert tg[0].dtype == torch.bfloat16
    assert _rel(tg[0].float().numpy(), np.asarray(rg[0], np.float32)) < 1e-2
    for i in range(1, 6):
        assert tg[i].shape == rg[i].shape, i
        assert _rel(tg[i].numpy(), np.asarray(rg[i])) < 1e-3, i
    # the CPU wrappers are the plain versions
    torch.testing.assert_close(mix_heads_r1_fwd(*t, K=K, act_kind=act), got,
                               rtol=0, atol=0)
    for x, y in zip(mix_heads_r1_bwd(*t[:5], torch.from_numpy(g), K=K,
                                     act_kind=act), tg):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _r1_posterior(B=3, M=25, zd=2, seed=1):
    """Mode B's K3 inputs: raw heads (B, M, 1, D), p_r and the offset 0,
    the translation log prior of a 5 x 5 grid as p_tr (M, 1), the grid and
    sig_r = pi."""
    rng = np.random.default_rng(seed)
    ad = int(round(M ** 0.5))
    heads = rng.normal(size=(B, M, 1, 3 + 2 * zd)).astype(np.float32)
    heads[..., 0] *= 2.0
    heads[..., 2] *= 0.3
    heads[..., 3 + zd:] *= 0.3
    grid = attention_grid(ad, 14)
    return (heads, np.zeros(1, np.float32), np.zeros(1, np.float32),
            _translation_log_prior(grid)[:, None], grid.astype(np.float32),
            float(np.pi))


@pytest.mark.parametrize("zd", [2, 3])
def test_r1_posterior_plain_matches_pallas(jx, zd):
    """K3's and K4's plain versions at R = 1 (mode B's posterior) against
    the Pallas kernel in interpret mode, deterministic, fed the planes the
    JAX package's mode-B kernel branch forms (elbo.py:252-278): float32 on
    both sides, 1e-4 (forward) and 1e-4 relative L2 (the VJP)."""
    jnp = jx.jnp
    heads, p_r, offs, p_tr, grid, sig = _r1_posterior(zd=zd)
    b, m = heads.shape[:2]
    planes = (heads[:, :, 0, 0][:, None], heads[:, :, 0, 1][:, None],
              heads[:, :, 0, 2][:, None],
              heads[:, :, 0, 3:3 + zd].transpose(0, 2, 1)[:, :, None],
              heads[:, :, 0, 3 + zd:].transpose(0, 2, 1)[:, :, None])
    fn = lambda *pl: jx.post(jx.jax.random.key(9), *pl,
                             jnp.asarray(p_tr.T), jnp.asarray(grid),
                             jnp.zeros((1,), jnp.float32), sig,
                             deterministic=True, interpret=True)
    ref, vjp = jx.jax.vjp(fn, *[jnp.asarray(np.ascontiguousarray(p))
                                for p in planes])
    targs = [torch.from_numpy(a) for a in (heads, p_r, offs, p_tr, grid)]
    for got in (posterior_plain(*targs, sig),
                fused_posterior(9, *targs, sig, deterministic=True)):
        for name in ref:
            assert float(np.abs(got[name].numpy()
                                - np.asarray(ref[name])).max()) < 1e-4, name
    rng = np.random.default_rng(2)
    gd = {k: rng.normal(size=np.shape(v)).astype(np.float32)
          for k, v in ref.items()}
    rp = vjp({k: jnp.asarray(v) for k, v in gd.items()})
    g = torch.cat([torch.from_numpy(gd[k]).reshape(b, -1) for k in
                   ("z_mu_e", "z_std_e", "theta_mu_e", "theta_std_e", "dx",
                    "kl")], dim=1)
    dh = posterior_bwd_plain(g, *targs, sig).numpy()[:, :, 0]
    want = np.concatenate([np.asarray(rp[0])[:, 0, :, None],
                           np.asarray(rp[1])[:, 0, :, None],
                           np.asarray(rp[2])[:, 0, :, None],
                           np.asarray(rp[3])[:, :, 0].transpose(0, 2, 1),
                           np.asarray(rp[4])[:, :, 0].transpose(0, 2, 1)],
                          axis=2)
    assert _rel(dh, want) < 1e-4


@pytest.mark.parametrize("M", [2601, 25])
def test_r1_schedules_cover_ragged_images(M):
    """At R = 1 an image's M cells need not be a multiple of 4 (mode B's
    51 x 51 = 2,601): K3's and K4's schedules still start every CTA's chunk
    on a multiple of 4 cells (the kernels keep a chunk's cells at their
    device offset modulo 16 bytes, which is then one offset for all its
    pieces), cover the image, leave no CTA empty, and give the last CTA the
    ragged rest, which the kernels mask."""
    cs, chunk = k3_schedule(M, 1)
    cs4, chunk4, sub = k4_schedule(M, 1, 7)
    for c, n in ((cs, chunk), (cs4, chunk4)):
        assert n % 4 == 0 and (c - 1) * n < M <= c * n
    assert sub % 4 == 0 and sub <= chunk4
    assert M % 4 == 0 or M - (cs - 1) * chunk < chunk


def test_r1_schedules():
    """K3 spreads mode B's small images over 4 CTAs of at most 1,024 cells
    (K3_CELLS_R1); K4 holds them in 64 KB chunks; K2's channel pass puts
    every chunk of KI beside each run of tiles."""
    assert k3_schedule(2604, 1) == (4, 652)
    cs, chunk, sub = k4_schedule(2604, 1, 7)
    assert cs * chunk >= 2604 and chunk * 28 <= 64 * 1024 and sub == chunk
    assert k3_schedule(39 * 39, 8) == (4, 3044)      # mode C unchanged
    runs, per = r1_channel_schedule(260_100, 1024, 132)
    assert runs * per >= -(-260_100 // 128) and runs == 8
    assert r1_channel_schedule(5, 128, 132) == (1, 1)


@pytest.mark.parametrize("n, ki, sms", [
    (260_100, 128, 132), (260_100, 1024, 132), (1000, 136, 132),
    (130, 264, 132), (1, 8, 132), (300, 2048, 132), (4097, 1024, 7),
    (64, 136, 1)])
def test_r1_schedules_cover_each_position_and_channel_once(n, ki, sms):
    """K1's and K2's grids at R = 1, by the kernels' own index arithmetic:
    K1 (r1_fwd_schedule: 64-position tiles where W2 is resident, KI <= 256,
    else 128) gives every position to one block, no more blocks than SMs;
    K2's channel pass (r1_channel_schedule) gives every (position, 64-channel
    chunk of KI) to one block, the last chunk short where 64 does not
    divide KI."""
    blocks, chunk = r1_fwd_schedule(n, ki, sms)
    tile = R1_TILE if ki <= R1_RESIDENT_KI else FWD_TILE_POS
    tiles = -(-max(n, 1) // tile)
    assert blocks <= max(1, min(sms, tiles))
    seen = np.zeros(max(n, 1), np.int64)
    for b in range(blocks):
        i0, i1 = b * chunk, min(tiles, (b + 1) * chunk)
        assert i0 < i1
        seen[i0 * tile:min(n, i1 * tile)] += 1
    assert (seen[:n] == 1).all()
    runs, per = r1_channel_schedule(n, ki, sms)
    tiles = -(-max(n, 1) // FWD_TILE_POS)
    nc = -(-ki // 64)
    cover = np.zeros((max(n, 1), ki), np.int64)
    for blk in range(nc * runs):
        c, run = blk % nc, blk // nc
        i0, i1 = run * per, min(tiles, (run + 1) * per)
        assert i0 < i1
        cover[i0 * FWD_TILE_POS:min(n, i1 * FWD_TILE_POS),
              c * 64:min(ki, c * 64 + 64)] += 1
    assert (cover[:n] == 1).all()


# ---- the ELBO, its gradients, embed ----

def _port_grads(tm, y, compute_dtype=None):
    params = tm.params()
    elbo = compute_elbo(params, tm.cfg, tm.base_grid(), torch.from_numpy(y),
                        None, compute_dtype)[0]
    (-elbo).backward()
    trained = {"encoder": params["encoder"],
               "generator": {k: v for k, v in params["generator"].items()
                             if k != "fourier"}}
    return _map(lambda p: p.grad.numpy(), trained)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists, keys in sorted
    order (jax.tree's)."""
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_grads_close(got, ref, tol):
    """Each leaf within `tol` relative L2, but the attention head's bias:
    the softmax over the cells is invariant to a shift of every logit, so
    its exact gradient is zero and both sides hold rounding noise (held to
    |g| < 1e-4)."""
    for path, g in _leaves(got):
        r = ref
        for k in path:
            r = r[k]
        if path == ("encoder", "conv_a", "b"):
            assert np.abs(g).max() < 1e-4 and np.abs(r).max() < 1e-4
        else:
            assert _rel(g, r) < tol, (path, _rel(g, r))


@pytest.mark.parametrize("mode", list(MODES))
def test_elbo_and_gradients_match_jax(jx, mode, zero_noise):
    """Deterministic ELBO and the gradient of -ELBO over every parameter,
    the port's float32 tier against compute_elbo with the noise zeroed (as
    tests/test_kernels.py:279-322 holds the kernel tiers): rtol 2e-4 /
    atol 1e-4 and 2e-4 relative L2 a leaf."""
    jnp = jx.jnp
    jm, jp, tm = _pair(jx, mode)
    y = _images(4)
    ref = jx.elbo(jp, jm.cfg, jm.base_grid(), jnp.asarray(y),
                  jx.jax.random.key(1))
    with torch.inference_mode():
        got = compute_elbo(tm.params(), tm.cfg, tm.base_grid(),
                           torch.from_numpy(y), None)
    np.testing.assert_allclose([float(t) for t in got],
                               [float(t) for t in ref], rtol=RTOL, atol=ATOL)
    gref = jx.jax.grad(lambda p: -jx.elbo(
        p, jm.cfg, jm.base_grid(), jnp.asarray(y), jx.jax.random.key(1))[0])(
        jx.jax.tree.map(jnp.asarray, jp))
    gref = jx.jax.tree.map(np.asarray, gref)
    _assert_grads_close(_port_grads(tm, y), gref, 2e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_tier_tracks_f32_tier(jx, mode):
    """The bf16 tier (on the CPU the kernels' plain versions: the mode-B
    kernel route, K3/K4 at R = 1; hidden 32 is no width of the pose
    kernels, so the decoder runs the XLA bf16 recipe, as on the card)
    against the float32 tier, deterministic: the ELBO within 2e-2 relative
    (chip_smoke.TOL_ELBO) and each gradient leaf within 0.15 relative L2,
    the bound tests/test_torch_port_train.py holds mode C to at this size
    (bf16 operands move the tiny decoder's leaves by up to 0.15; at the
    full width chip_smoke.py holds every leaf to 0.05 but mode B's theta
    heads, held to 0.25, calibrated on the JAX package's own bf16 tier by
    tools/calibrate_mode_b_grad_tol.py)."""
    _, _, tm = _pair(jx, mode)
    y = _images(6)
    with torch.inference_mode():
        e32 = float(tm.elbo(tm.params(), tm.base_grid(),
                            torch.from_numpy(y), None)[0])
        e16 = float(tm.elbo(tm.params(), tm.base_grid(),
                            torch.from_numpy(y), None, torch.bfloat16)[0])
    assert abs(e16 - e32) <= 2e-2 * abs(e32)
    g32 = _port_grads(tm, y)
    tm.zero_grad(set_to_none=True)
    g16 = _port_grads(tm, y, torch.bfloat16)
    _assert_grads_close(g16, g32, 0.15)


@pytest.mark.parametrize("mode", list(MODES))
def test_embed_matches_jax(jx, mode):
    jm, jp, tm = _pair(jx, mode)
    y = _images(5)
    ref = jm.embed(jp, jx.jnp.asarray(y))
    with torch.inference_mode():
        got = tm.embed(tm.params(), torch.from_numpy(y))
        got16 = tm.embed(tm.params(), torch.from_numpy(y), torch.bfloat16)
    for name in ("z_content", "theta_mu", "dx"):
        assert got[name].shape == ref[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        assert got16[name].shape == got[name].shape
        assert bool(torch.isfinite(got16[name]).all())


# ---- parameters, checkpoints, the train CLI ----

@pytest.mark.parametrize("mode", list(MODES))
def test_params_and_checkpoints_round_trip(jx, mode, tmp_path):
    """params_from_jax / params_to_jax and the checkpoint files move the
    mode-A layers list and mode B's conv1 / fc_r between the packages
    unchanged, both ways."""
    from targetvae_tpu_torch.train.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
    jm, jp, tm = _pair(jx, mode)
    back = params_to_jax(tm.params())
    for (pa, a), (pb, b) in zip(_leaves(jp), _leaves(back)):
        assert pa == pb and np.array_equal(a, b), pa
    names = {n for n, _ in tm.named_parameters()}
    if mode == "A":
        assert "encoder.layers.2.w" in names
    else:
        assert ("encoder.fc_r.w" in names) == (mode == "B8")
    path = str(tmp_path / "port.sav")
    save_checkpoint(path, tm.params(), tm.cfg, step=3)
    jparams, jcfg, _ = jx.checkpoint.load_checkpoint(path)
    assert jcfg == jm.cfg
    for (pa, a), (pb, b) in zip(_leaves(jp), _leaves(jparams)):
        assert pa == pb and np.array_equal(a, np.asarray(b)), pa
    jpath = str(tmp_path / "jax.sav")
    jx.checkpoint.save_checkpoint(jpath, jp, jm.cfg, step=3)
    tparams, tcfg, _ = load_checkpoint(jpath)
    fresh = TargetVAE(tcfg, "cpu")
    fresh.load_params(params_from_jax(tparams))
    y = torch.from_numpy(_images(3))
    with torch.inference_mode():
        a, b = fresh.embed(fresh.params(), y), tm.embed(tm.params(), y)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _blobs(n, seed, d=12):
    r = np.random.RandomState(seed)
    ys = np.zeros((n, d, d), np.uint8)
    for i in range(n):
        cx, cy = r.randint(3, d - 3, 2)
        ys[i, cy - 2:cy + 2, cx - 2:cx + 2] = 255
    return ys


@pytest.mark.parametrize("mode, flags", [
    ("A", ["--t-inf", "unimodal", "--r-inf", "unimodal"]),
    ("B0", ["--t-inf", "attention", "--r-inf", "unimodal", "--groupconv",
            "0"]),
    ("B4", ["--t-inf", "attention", "--r-inf", "unimodal", "--groupconv",
            "4", "--compute-dtype", "bfloat16"])])
def test_train_mnist_one_epoch(tmp_path, mode, flags):
    """One tiny epoch of the train CLI on the CPU in each mode: the run
    directory as the JAX package names it, finite TSV lines, the
    checkpoints, and load_encoder's embed equal to the run's own."""
    from targetvae_tpu_torch.cli import train_mnist
    from targetvae_tpu_torch.cli.clustering_common import load_encoder
    root = tmp_path / "data" / "mnist_U"
    root.mkdir(parents=True)
    np.save(root / "images_train.npy", _blobs(30, 0))
    np.save(root / "images_test.npy", _blobs(10, 1))
    logs = tmp_path / "logs"
    state = train_mnist.main(
        ["--dataset", "mnist-U", "--image-dim", "12", "--z-dim", "2",
         "--encoder-kernel-number", "16", "--generator-hidden-dim", "32",
         "--minibatch-size", "20", "--num-epochs", "1", "-d", "-1",
         "--data-root", str(tmp_path / "data"), "--log-root", str(logs)]
        + flags)
    (run,) = os.listdir(logs)
    t_inf, r_inf = flags[1], flags[3]
    tail = {"A": "_groupconv8", "B0": "", "B4": "_groupconv4"}[mode]
    assert run.endswith(f"_mnist-U_zDim_2_translation_{t_inf}_rotation_"
                        f"{r_inf}{tail}")
    rows = [ln.split("\t") for ln in
            open(logs / run / "train_log.txt").read().splitlines()]
    rows = [r for r in rows if len(r) == 5 and r[1] in ("train", "test")]
    assert [r[1] for r in rows] == ["train", "test"]
    assert all(np.isfinite(float(v)) for r in rows for v in r[2:])
    em, ep = load_encoder(str(logs / run / "inference.sav"), device="cpu")
    assert em.cfg.encoder.mode == mode[0]
    y = torch.from_numpy(_blobs(3, 4)[..., None] / 255.0).float()
    with torch.inference_mode():
        a = em.embed(ep, y)
        b = state.model.embed(state.model.params(), y)
    for name in a:
        assert torch.equal(a[name], b[name]), name


# ---- the kernels on the card ----

R1_CASES = [(128, 128, 700, "leakyrelu", 7), (128, 1024, 2000, "tanh", 7),
            (64, 512, 65, "leakyrelu", 16), (16, 32, 1, "tanh", 5),
            (128, 2048, 300, "leakyrelu", 7), (32, 264, 130, "leakyrelu", 7),
            (128, 1024, 4000, "leakyrelu", 7), (128, 128, 3000, "tanh", 7),
            (128, 136, 2500, "leakyrelu", 7), (64, 136, 129, "tanh", 3)]


@pytest.mark.parametrize("K, KI, N, act, D", R1_CASES)
def test_mix_heads_r1_kernels_on_cuda(cuda, K, KI, N, act, D):
    """K1 and K2 at R = 1 against their plain versions: the forward within
    5e-3 (chip_smoke.TOL_K1), dpre1 one bf16 step (1e-2 relative L2), the
    weight gradients 1e-3 relative L2 (chip_smoke's K2 bounds); reruns
    bitwise equal."""
    args = [torch.from_numpy(a).to(cuda) for a in _r1_inputs(KI, K, D, N)]
    args[0] = args[0].to(torch.bfloat16)
    g = torch.randn(N, D, generator=torch.Generator().manual_seed(4)).to(cuda)
    kernels.reset_launch_counts()
    got = fused_mix_heads_r1(*args, K=K, act_kind=act)
    again = mix_heads_r1_fwd(*args, K=K, act_kind=act)
    gb = mix_heads_r1_bwd(*args[:5], g, K=K, act_kind=act)
    gb2 = mix_heads_r1_bwd(*args[:5], g, K=K, act_kind=act)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["mix_heads_r1_fwd"] == 2 and counts["mix_heads_r1_bwd"] == 2
    assert counts["mix_heads_fwd"] == counts["mix_heads_bwd"] == 0
    ref = lift_act_mix_heads_plain(*args, R=1, K=K, act_kind=act)
    assert got.shape == ref.shape == (N, D)
    assert float((got - ref).abs().max()) < 5e-3
    assert torch.equal(got, again)
    rb = lift_act_mix_heads_bwd_plain(*args[:5], g, R=1, K=K, act_kind=act)
    assert gb[0].dtype == torch.bfloat16 and gb[0].shape == (N, KI)
    assert _rel(gb[0].float().cpu(), rb[0].float().cpu()) <= 1e-2
    for i in range(1, 6):
        assert gb[i].shape == rb[i].shape, i
        assert _rel(gb[i].cpu(), rb[i].cpu()) < 1e-3, (i, _rel(gb[i].cpu(),
                                                             rb[i].cpu()))
    assert all(torch.equal(a, b) for a, b in zip(gb, gb2))


@pytest.mark.parametrize("M, zd", [(225, 2), (2601, 2), (196, 8), (49, 3)])
def test_posterior_r1_kernels_on_cuda(cuda, M, zd):
    """K3 and K4 at R = 1 (mode B's posterior; at M = 225, 2,601 and 49 an
    image starts 4, 8 or 12 bytes past a 16-byte boundary and its last
    chunk ends between two, which the kernels mask) against their plain
    versions, deterministic and sampled (the plain versions fed the
    kernels' Philox noise), on the default schedules and on two CTAs an
    image with K4 streaming sub-chunks of 12 cells: 1e-4 a unit
    (chip_smoke.TOL_K3, TOL_K4)."""
    heads, *consts = _r1_posterior(B=5, M=M, zd=zd)
    targs = ([torch.from_numpy(a).to(cuda) for a in (heads, *consts[:4])]
             + [consts[4]])
    per_unit = lambda a, b: float(((a - b).abs()
                                   / b.abs().clamp(min=1.0)).max())
    g = torch.randn(5, 2 * zd + 5,
                    generator=torch.Generator().manual_seed(5)).to(cuda)
    half = -(-M // 8) * 4
    for k3s, k4s in ((None, None), ((2, half), (2, half, 12))):
        for det in (True, False):
            noise = None if det else philox_gumbel(7, 5, 1, M, cuda)
            got = posterior_fwd(7, *targs, deterministic=det, schedule=k3s)
            ref = torch.cat([v.reshape(5, -1) for v in posterior_plain(
                *targs, noise=noise).values()], dim=1)
            assert per_unit(got, ref) < 1e-4, (k3s, det)
            dh = posterior_bwd(7, g, *targs, deterministic=det,
                               schedule=k4s)
            dref = posterior_bwd_plain(g, *targs, noise=noise)
            assert dh.shape == dref.shape == targs[0].shape
            assert per_unit(dh, dref) < 1e-4, (k4s, det)
