"""The grid-sharded posterior (compute_elbo(sp=group)) on the float32 tier
and in mode B, on CPU gloo ranks, against the unsharded ELBO and the JAX
package.

One spawn of 7 ranks for the module; each case runs on the first T ranks
as a group of its own, every rank holding its rows of the batch:

- float32, modes C and B, T = 2: deterministic and sampled (the Gumbel
  noise one draw for the whole grid from the group's generator): the ELBO
  and every gradient equal the unsharded float32 ELBO's from the same
  generator; deterministic, also JAX's compute_elbo(sp=(mesh, "model"));
- the padding property at 3, 5 and 7 shards (tests/test_parallel.py::
  test_sp_padding_property's grids: mode B's 17 x 17 = 289 cells, a mode-C
  grid of 11 x 11 x 4 = 484, neither a multiple of any of them);
- mode B on the bf16 tier (K5/K6's plain versions here), T = 2, against
  the unsharded bf16 ELBO (K3/K4's plain versions);
- the sharded log-softmax, Gumbel-softmax and weighted moments.

Tolerances: the metrics at 1e-5 relative against the unsharded ELBO.
Each float32 gradient leaf at 2e-4 relative L2 (tests/test_torch_port_tp.
py's float32 bound against JAX's sharded step) against the unsharded
float32 ELBO without noise and at the padding property, and against JAX's
compute_elbo(sp=(mesh, "model")) with and without noise; the sampled
float32 SP step against the unsharded one at 1e-3: at mode B's sampled
case the ELBO sits next to a kink of its gradient (a leaky ReLU whose
input crosses zero), where a 1e-6 relative change of the Gumbel noise
moves the unsharded gradient itself by 1.2e-3 (tools/read_grad_kink.py),
and the sharded sums move theta and dx by a rounding step. On the bf16
tier each leaf at 1e-2, PERF.md section 2's SP bound. The attention bias,
whose exact gradient is 0, below 1e-3 of the attention weight's.
"""

import numpy as np
import pytest
import torch

from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.losses.elbo import compute_elbo
from targetvae_tpu_torch.utils.config import (
    EncoderConfig, GeneratorConfig, LikelihoodConfig)

import torch_port_ranks

SPAWN_TIMEOUT = 300
SHIFT = "encoder.conv_a.b"
TOL_SP_GRAD = 1e-2           # bf16
TOL_F32_SP_GRAD = 2e-4       # float32
TOL_F32_SAMPLED_GRAD = 1e-3  # float32, sampled, against the unsharded step
SEED = 5


def _gen():
    return GeneratorConfig(z_dim=2, hidden_dim=32, n_out=1, num_layers=2,
                           fourier_expansion=True, embedding_dim=64)


def _configs():
    return {
        "C": ModelConfig(_gen(), EncoderConfig(
            image_dim=14, z_dim=2, kernels_num=16, kernels_size=8, padding=3,
            groupconv=4), LikelihoodConfig()),
        "B": ModelConfig(_gen(), EncoderConfig(
            t_inf="attention", r_inf="unimodal", image_dim=14, z_dim=2,
            kernels_num=16, groupconv=0), LikelihoodConfig()),
        # test_sp_padding_property's grids
        "B289": ModelConfig(_gen(), EncoderConfig(
            t_inf="attention", r_inf="unimodal", image_dim=16, z_dim=2,
            kernels_num=8, groupconv=0), LikelihoodConfig()),
        "C484": ModelConfig(_gen(), EncoderConfig(
            image_dim=10, z_dim=2, kernels_num=8, kernels_size=4, padding=2,
            groupconv=4), LikelihoodConfig()),
    }


def _images(n, d, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, d, d, 1)).astype(
        np.float32)


def _cases():
    """{key: case}: the config, its T ranks, the batch (T rows at the
    padding property, 4 otherwise), the generator's seed (None: no noise)
    and the tier."""
    cases = {}
    for mode in ("C", "B"):
        for seed in (None, SEED):
            cases[f"f32_{mode}_{seed}"] = {"cfg": mode, "ranks": 2, "n": 4,
                                           "seed": seed, "bf16": False}
    cases["bf16_B"] = {"cfg": "B", "ranks": 2, "n": 4, "seed": None,
                       "bf16": True}
    for cfg in ("B289", "C484"):
        for t in (3, 5, 7):
            cases[f"pad_{cfg}_{t}"] = {"cfg": cfg, "ranks": t, "n": t,
                                       "seed": None, "bf16": False}
    return cases


def _params(cfg):
    import jax
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.utils import config as jcfg
    from targetvae_tpu_torch.utils.jax_params import params_from_jax
    jm = JaxTargetVAE(jcfg.ModelConfig.from_json(cfg.to_json()))
    jp = jm.init(jax.random.key(0))
    return jm, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _softmax_inputs():
    rng = np.random.default_rng(3)
    attn = (rng.normal(size=(3, 40)) * 2).astype(np.float32)
    noise = rng.gumbel(size=(3, 40)).astype(np.float32)
    z = rng.normal(size=(3, 40, 5)).astype(np.float32)
    return attn, noise, z


@pytest.fixture(scope="module")
def spawned():
    from targetvae_tpu_torch.parallel.distributed import run_local
    configs = _configs()
    cases = {}
    for key, c in _cases().items():
        cfg = configs[c["cfg"]]
        cases[key] = dict(c, cfg=cfg.to_json(), params=c["cfg"],
                          y=_images(c["n"], cfg.encoder.image_dim, 1))
    inp = {"cases": cases, "softmax": _softmax_inputs(),
           "params": {k: _params(cfg)[2] for k, cfg in configs.items()}}
    ranks = run_local(torch_port_ranks.sp_modes_work, 7, backend="gloo",
                      timeout=SPAWN_TIMEOUT, args=(inp,))
    return inp, ranks


def _unsharded(case, params, compute_dtype=None):
    """The unsharded ELBO's [elbo, log_p, kl] and gradients of -elbo on the
    case's whole batch, from a generator seeded as the group's."""
    cfg = ModelConfig.from_json(case["cfg"])
    model = TargetVAE(cfg, device="cpu")
    model.load_params(torch_port_ranks._clone(params))
    gen = (None if case["seed"] is None
           else torch.Generator().manual_seed(case["seed"]))
    out = compute_elbo(model.params(), cfg, model.base_grid(),
                       torch.from_numpy(case["y"]), gen,
                       compute_dtype=compute_dtype)
    (-out[0]).backward()
    return (torch.stack(out).detach().numpy(),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _held(got, metrics, grads, grad_tol):
    np.testing.assert_allclose(got["metrics"], metrics, rtol=1e-5)
    floor = 1e-3 * np.linalg.norm(grads["encoder.conv_a.w"])
    for name, g in grads.items():
        if name == SHIFT:
            assert np.linalg.norm(got["grads"][name]) <= floor, name
        else:
            assert _rel(got["grads"][name], g) <= grad_tol, (
                name, _rel(got["grads"][name], g))


@pytest.mark.parametrize("mode", ["C", "B"])
@pytest.mark.parametrize("seed", [None, SEED])
def test_f32_sp_equals_unsharded(spawned, mode, seed):
    """float32 SP on 2 ranks, deterministic and sampled: the metrics and
    gradients of the unsharded float32 ELBO on the same 4 images from the
    same generator, on both ranks (the sample is the unsharded one)."""
    inp, ranks = spawned
    case = inp["cases"][f"f32_{mode}_{seed}"]
    metrics, grads = _unsharded(case, inp["params"][mode])
    tol = TOL_F32_SP_GRAD if seed is None else TOL_F32_SAMPLED_GRAD
    for r in ranks[:2]:
        _held(r[f"f32_{mode}_{seed}"], metrics, grads, tol)


def _jax_grads(ref) -> dict:
    """JAX gradients by the port's parameter names."""
    import jax
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(ref):
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        out["spatial_" + name if name.startswith("generator")
            else name] = np.asarray(v)
    return out


def _held_to_jax(got, ref_metrics, ref_grads):
    """The port's group metrics and summed gradients against the JAX
    package's: metrics at rtol 2e-4 / atol 1e-4, every leaf at 2e-4
    relative L2 (the attention bias's, exactly 0, below 1e-3 of the
    attention weight's)."""
    np.testing.assert_allclose(got["metrics"], ref_metrics, rtol=2e-4,
                               atol=1e-4)
    floor = 1e-3 * np.linalg.norm(ref_grads["encoder.conv_a.w"])
    for name, g in got["grads"].items():
        if name == SHIFT:
            assert np.linalg.norm(g) <= floor, name
        else:
            assert _rel(g, ref_grads[name]) <= TOL_F32_SP_GRAD, (
                name, _rel(g, ref_grads[name]))


def _jax_sp_elbo(jm, jp, y):
    """The JAX package's compute_elbo(sp=(mesh, "model")) on a (1, 2) mesh
    of its CPU devices: [elbo, log_p, kl] and the gradients of -elbo."""
    import jax
    import jax.numpy as jnp
    from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
    from targetvae_tpu.parallel import make_mesh
    mesh = make_mesh(jax.devices()[:2], data=1, model=2)

    def neg_elbo(p):
        out = jax_compute_elbo(p, jm.cfg, jm.base_grid(), jnp.asarray(y),
                               jax.random.key(0), sp=(mesh, "model"))
        return -out[0], out
    (_, out), grads = jax.jit(jax.value_and_grad(neg_elbo,
                                                 has_aux=True))(jp)
    return [float(v) for v in out], _jax_grads(grads)


@pytest.mark.parametrize("mode", ["C", "B"])
def test_f32_sp_matches_jax_compute_elbo_sp(spawned, mode, monkeypatch):
    """The float32 SP ELBO on 2 ranks against the JAX package's
    compute_elbo(sp=(mesh, "model")) on a (1, 2) mesh of its CPU devices,
    the same weights and images, no sampling noise: the metrics and
    every gradient leaf (both the sharded sums)."""
    import jax
    import jax.numpy as jnp
    import targetvae_tpu.models.encoders as jax_enc
    inp, ranks = spawned
    jm, jp, _ = _params(_configs()[mode])
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax_enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))
    case = inp["cases"][f"f32_{mode}_None"]
    metrics, grads = _jax_sp_elbo(jm, jp, case["y"])
    for r in ranks[:2]:
        _held_to_jax(r[f"f32_{mode}_None"], metrics, grads)


def test_f32_sp_sampled_matches_jax_compute_elbo_sp(spawned, monkeypatch):
    """The sampled float32 SP step (mode C, 2 ranks) against the JAX
    package's compute_elbo(sp=(mesh, "model")) handed the same noise: the
    whole grid's Gumbel draw and the z and theta normals, taken in the
    port's order from a generator seeded as the group's. The metrics and
    every gradient leaf as without noise. (Mode B's sampled case sits at a
    kink of its gradient, where the JAX package's own gradient moves by
    1.9e-2 under a 1e-6 relative change of the noise: tools/
    read_grad_kink.py.)"""
    import jax
    import jax.numpy as jnp
    from targetvae_tpu_torch.ops.gumbel import gumbel_noise
    inp, ranks = spawned
    jm, jp, _ = _params(_configs()["C"])
    gen = torch.Generator().manual_seed(SEED)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
                            gumbel_noise(tuple(shape), gen).numpy(), dtype))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
                            torch.randn(tuple(shape), generator=gen).numpy(),
                            dtype))
    case = inp["cases"][f"f32_C_{SEED}"]
    metrics, grads = _jax_sp_elbo(jm, jp, case["y"])
    for r in ranks[:2]:
        _held_to_jax(r[f"f32_C_{SEED}"], metrics, grads)


@pytest.mark.parametrize("cfg", ["B289", "C484"])
@pytest.mark.parametrize("t", [3, 5, 7])
def test_sp_padding_property(spawned, cfg, t):
    """Grids no shard count divides (289 and 484 cells at 3, 5 and 7
    shards, one image a rank): the -1e30 pads carry no mass, so the SP
    ELBO and its gradients equal the unsharded ones."""
    inp, ranks = spawned
    key = f"pad_{cfg}_{t}"
    case = inp["cases"][key]
    cells = {"B289": 289, "C484": 484}[cfg]
    assert cells % t
    metrics, grads = _unsharded(case, inp["params"][cfg])
    assert np.isfinite(metrics).all()
    for r in ranks[:t]:
        _held(r[key], metrics, grads, TOL_F32_SP_GRAD)
    assert all(key not in r for r in ranks[t:])


def test_mode_b_bf16_sp_equals_unsharded(spawned):
    """Mode B's bf16 SP step on 2 ranks (K1/K2 at R = 1, K5/K6: their
    plain versions here) against the unsharded bf16 ELBO (K3/K4's plain
    versions): metrics at 1e-5, gradients within the SP bound."""
    inp, ranks = spawned
    case = inp["cases"]["bf16_B"]
    metrics, grads = _unsharded(case, inp["params"]["B"], torch.bfloat16)
    for r in ranks[:2]:
        _held(r["bf16_B"], metrics, grads, TOL_SP_GRAD)


def test_sharded_softmax_and_moments(spawned):
    """sharded_log_softmax over 2 ranks' halves of 40 cells equals the
    log-softmax over all 40, the Gumbel-softmax the softmax of the logits
    plus the given noise, the weighted moments their expectation."""
    attn, noise, z = _softmax_inputs()
    _, ranks = spawned
    q = np.concatenate([r["softmax"]["q"] for r in ranks[:2]], axis=1)
    a = np.concatenate([r["softmax"]["a"] for r in ranks[:2]], axis=1)
    t = torch.from_numpy
    np.testing.assert_allclose(q, torch.log_softmax(t(attn), 1).numpy(),
                               rtol=1e-6, atol=1e-6)
    ref_a = torch.softmax(t(attn + noise), 1).numpy()
    np.testing.assert_allclose(a, ref_a, rtol=1e-5, atol=1e-7)
    for r in ranks[:2]:
        np.testing.assert_allclose(r["softmax"]["ez"],
                                   np.einsum("bm,bmd->bd", ref_a, z),
                                   rtol=1e-5, atol=1e-6)
