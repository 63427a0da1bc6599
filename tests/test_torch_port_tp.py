"""The port's tensor parallelism (tp > 1 without sp) on CPU gloo ranks,
against the JAX package and against one process.

- the layout: each leaf's shard axis against the JAX package's
  param_shardings on its 8-device CPU mesh (modes A, B and C, the
  particles model; a data 2 x model 3 mesh whose kernels_num 16 does not
  divide by 3, so that the guard keeps those leaves whole);
- dp = 2 x tp = 2 on 4 ranks (one spawn for the module): one
  deterministic step on each tier against the one-process step, on
  float32 also against JAX's _step_impl on a (2, 2) mesh through
  shard_state; the sharded Adam step bitwise the replicated one; a ragged
  epoch of 2 B - 1 rows; a TP checkpoint that loads in the JAX package and
  in one process, a one-process checkpoint loaded sharded, a resume
  bitwise.

Tolerances: float32 against one process at 1e-5 relative (metrics) and
1e-5 relative L2 (each gradient leaf), the bounds of
tests/test_torch_port_dp.py; bf16 gradients at the SP bound 1e-2 (each
rank's bf16 weight-gradient products round over its own rows); against
the JAX package's sharded step tests/test_parallel.py's rtol 2e-4 / atol
1e-3 on the metrics and 2e-4 relative L2 a gradient leaf (the JAX step's
gradient read from Adam's first moment, mu = 0.1 g). The attention bias,
whose exact gradient is 0, is held to a floor of 1e-3 of the attention
weight's gradient.
"""

import numpy as np
import pytest
import torch

from targetvae_tpu_torch import ModelConfig
from targetvae_tpu_torch.parallel.mesh import param_layout
from targetvae_tpu_torch.train import Trainer, create_train_state
from targetvae_tpu_torch.utils.config import (
    EncoderConfig, GeneratorConfig, LikelihoodConfig, TrainConfig)

import torch_port_ranks
from torch_port_ranks import _clone, _grads, _params

SPAWN_TIMEOUT = 300
LR = 1e-3
SHIFT = "encoder.conv_a.b"
TOL_SP_GRAD = 1e-2


def _config(d=14, hidden=32):
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=hidden, n_out=1,
                                  num_layers=2, fourier_expansion=True,
                                  fourier_sigma=2.0 / (d - 1),
                                  embedding_dim=64),
        encoder=EncoderConfig(image_dim=d, z_dim=2, kernels_num=16,
                              kernels_size=8, padding=3, groupconv=4),
        likelihood=LikelihoodConfig(kind="bernoulli"))


def _layout_configs():
    """(name, config): the layout's model families at small widths."""
    g = GeneratorConfig(z_dim=2, hidden_dim=48, n_out=1, num_layers=3,
                        fourier_expansion=True, embedding_dim=64)
    return {
        "C": _config(),
        "B0": ModelConfig(g, EncoderConfig(t_inf="attention",
                                           r_inf="unimodal", image_dim=14,
                                           kernels_num=16, groupconv=0)),
        "B8": ModelConfig(g, EncoderConfig(t_inf="attention",
                                           r_inf="unimodal", image_dim=14,
                                           kernels_num=16, groupconv=8)),
        "A": ModelConfig(g, EncoderConfig(t_inf="unimodal",
                                          r_inf="unimodal", image_dim=14,
                                          kernels_num=16, num_layers=2)),
        "particles": ModelConfig(
            GeneratorConfig(z_dim=2, hidden_dim=48, n_out=2, num_layers=2,
                            fourier_expansion=True, embedding_dim=64),
            EncoderConfig(t_inf="attention", r_inf="attention+offsets",
                          image_dim=20, kernels_num=16, kernels_size=12,
                          padding=3, groupconv=8,
                          normal_prior_over_r=False),
            LikelihoodConfig(kind="gaussian", fit_noise=True, use_ctf=True,
                             mask_radius=8)),
    }


def _images(n, seed=0, d=14):
    return np.random.default_rng(seed).uniform(0, 1, (n, d, d, 1)).astype(
        np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _jax_params(cfg):
    import jax
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.utils import config as jcfg
    from targetvae_tpu_torch.utils.jax_params import params_from_jax
    jm = JaxTargetVAE(jcfg.ModelConfig.from_json(cfg.to_json()))
    jp = jm.init(jax.random.key(0))
    return jm, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("name,data,model", [
    ("C", 4, 2), ("B0", 4, 2), ("B8", 4, 2), ("A", 4, 2),
    ("particles", 4, 2), ("C", 2, 3), ("particles", 2, 3)])
def test_layout_matches_jax_param_shardings(name, data, model):
    """Every leaf's shard axis (None: whole) equals the model axis's place
    in the JAX package's param_shardings spec on a data x model mesh of
    its CPU devices. On the 2 x 3 mesh kernels_num 16 does not divide:
    the encoder's leaves stay whole, and so does the mode-C model's
    generator (hidden 32); the particles model's 48 hidden units shard."""
    import jax
    from targetvae_tpu.parallel import make_mesh
    from targetvae_tpu.parallel.mesh import param_shardings
    cfg = _layout_configs()[name]
    _, jp, params = _jax_params(cfg)
    mesh = make_mesh(jax.devices()[:data * model], data=data, model=model)
    specs = {jax.tree_util.keystr(k): s.spec for k, s in
             jax.tree_util.tree_leaves_with_path(param_shardings(mesh, jp))}
    got = param_layout(params, model)
    assert len(got) == len(specs)
    for path, axis in got.items():
        key = "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                      for p in path.split("/"))
        spec = tuple(specs[key])
        assert axis == (spec.index("model") if "model" in spec else None), (
            path, axis, spec)
    sharded = [p for p, a in got.items() if a is not None]
    if model == 3:
        assert not any(p.startswith("encoder") for p in sharded)
        assert ("generator/hidden/0/w" in sharded) == (name == "particles")
    elif name != "A":
        assert "encoder/conv2/w" in sharded


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    """dp = 2 x tp = 2 on 4 gloo ranks, one spawn: the rank functions are
    torch_port_ranks.tp_work. The one-process checkpoint they load is
    written here first."""
    from targetvae_tpu_torch.parallel.distributed import run_local
    from targetvae_tpu_torch.train import save_train_state
    root = tmp_path_factory.mktemp("tp")
    _, _, params = _jax_params(_config())
    tr = Trainer(_config(), TrainConfig(learning_rate=LR), device="cpu")
    state = tr.init_state(3)
    for _ in range(2):
        state, _ = tr.train_step(state, _images(8, 1))
    one = str(root / "one.sav")
    save_train_state(one, state, _config(), {"epoch": 2})
    inp = {"cfg": _config().to_json(), "lr": LR, "params": params,
           "y": _images(8, 1), "epoch_y": _images(15, 2), "root": str(root),
           "one_process_file": one}
    ranks = run_local(torch_port_ranks.tp_work, 4, backend="gloo",
                      timeout=SPAWN_TIMEOUT, args=(inp,))
    return inp, ranks, {"state": state, "trainer": tr}


def _single(compute_dtype=None, lr=LR, params=None, batch=100):
    tr = Trainer(_config(), TrainConfig(learning_rate=lr,
                                        compute_dtype=compute_dtype,
                                        minibatch_size=batch), device="cpu")
    if params is None:
        state = tr.init_state(0)
        state.generator = None
    else:
        tr.model.load_params(_clone(params))
        state = create_train_state(tr.model, lr, None)
    return tr, state


def _port_name(path) -> str:
    """A JAX pytree path as the port's parameter name."""
    name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)
    return "spatial_" + name if name.startswith("generator") else name


def _close_grads(got, ref, tol):
    floor = 1e-3 * np.linalg.norm(got["encoder.conv_a.w"])
    for name, r in ref.items():
        if name == SHIFT:
            assert np.linalg.norm(got[name]) <= floor, name
            continue
        assert _rel(got[name], r) <= tol, (name, _rel(got[name], r))


@pytest.mark.parametrize("tier,metric_tol,grad_tol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 1e-5, TOL_SP_GRAD)])
def test_dp_tp_step_matches_one_process(tp_ranks, tier, metric_tol,
                                        grad_tol):
    """One deterministic step on dp = 2 x tp = 2 (2 rows a rank, the
    flattened rows d * 2 + t) equals the one-process step on the 8
    images: metrics and every gradient leaf; the ranks gather the same
    parameters, bitwise."""
    inp, ranks, _ = tp_ranks
    tr, state = _single(None if tier == "float32" else tier,
                        params=inp["params"])
    _, m = tr.train_step(state, inp["y"])
    for i, r in enumerate(ranks):
        got = r[tier]
        assert got["mesh"] == (i // 2, i % 2)
        assert got["rows"] == slice(2 * i, 2 * i + 2)
        np.testing.assert_allclose(got["metrics"], m.numpy(), rtol=metric_tol)
        _close_grads(got["grads"], _grads(tr.model), grad_tol)
        for name, v in ranks[0][tier]["params"].items():
            np.testing.assert_array_equal(got["params"][name], v)


def test_sharded_adam_is_bitwise_the_replicated_adam(tp_ranks):
    """Adam on the shards, gathered, is bitwise Adam on the whole leaves
    given the same all-reduced gradients; each rank holds the whole
    parameters and gradients, and Adam's moments of the replicated leaves
    and of its half of every sharded leaf."""
    _, ranks, _ = tp_ranks
    for r in ranks:
        for tier in ("float32", "bfloat16"):
            got = r[tier]
            for name, v in got["replicated_adam"].items():
                np.testing.assert_array_equal(got["params"][name], v)
        b = r["float32"]["bytes"]
        assert b["grads"] == b["params"]
        assert b["params"] < b["adam"] < 2 * b["params"]


def test_dp_tp_step_matches_jax_sharded_step(tp_ranks, monkeypatch):
    """The float32 step against the JAX package's _step_impl on a (2, 2)
    mesh of its CPU devices through shard_state, without sampling noise:
    the metrics at rtol 2e-4 / atol 1e-3 and every gradient leaf (the JAX
    step's, from its Adam first moment) at 2e-4 relative L2."""
    import jax
    import jax.numpy as jnp
    import targetvae_tpu.models.encoders as jax_enc
    from targetvae_tpu.parallel import make_mesh
    from targetvae_tpu.parallel.pjit import shard_batch, shard_state
    from targetvae_tpu.train import Trainer as JaxTrainer
    from targetvae_tpu.utils import config as jcfg
    inp, ranks, _ = tp_ranks
    jm, jp, _ = _jax_params(_config())
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax_enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))
    jtr = JaxTrainer(jm, jcfg.TrainConfig(learning_rate=LR, dp=2, tp=2))
    mesh = make_mesh(jax.devices()[:4], data=2, model=2)
    jtr.attach_mesh(mesh)
    state = shard_state(mesh, jtr.init_state(0)._replace(params=jp))
    ys, _ = shard_batch(mesh, jnp.asarray(inp["y"]))
    state, m = jax.jit(jtr._step_impl)(state, ys)
    got = ranks[0]["float32"]
    np.testing.assert_allclose(got["metrics"], np.asarray(m), rtol=2e-4,
                               atol=1e-3)
    mu = state.opt_state.inner_state[0].mu
    for path, v in jax.tree_util.tree_leaves_with_path(mu):
        name = _port_name(path)
        if "fourier" in name or name == SHIFT:
            continue
        assert _rel(got["grads"][name], np.asarray(v) / 0.1) <= 2e-4, name


def test_ragged_epoch_at_tp_two(tp_ranks):
    """15 rows at B = 8 on dp = 2 x tp = 2: a full batch and a tail of 7
    padded to 8 with a zero-weight row, two steps, finite weighted
    metrics; at lr 0 the epoch's means equal one process's (1e-5); the
    ranks hold the same parameters bitwise."""
    inp, ranks, _ = tp_ranks
    tr, state = _single(lr=0.0, batch=8)
    _, means = tr.train_epoch(state, inp["epoch_y"])
    for r in ranks:
        for key in ("ragged_lr0", "ragged"):
            assert r[key]["steps"] == 2
            assert np.isfinite(r[key]["means"]).all()
            for name, v in ranks[0][key]["params"].items():
                np.testing.assert_array_equal(r[key]["params"][name], v)
        np.testing.assert_allclose(r["ragged_lr0"]["means"], means,
                                   rtol=1e-5)


def test_tp_checkpoint_loads_in_jax_and_one_process(tp_ranks):
    """The TP run's resume file (rank 0 writes what the ranks gather)
    loads in the JAX package's load_train_state and in a one-process
    port run: the parameters bitwise the ranks' gathered ones, Adam's
    moments whole and equal in both packages."""
    import jax
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.train import Trainer as JaxTrainer
    from targetvae_tpu.train.checkpoint import load_train_state as jax_load
    from targetvae_tpu.utils import config as jcfg
    from targetvae_tpu_torch.train import load_train_state
    inp, ranks, _ = tp_ranks
    path = inp["root"] + "/tp.sav"
    saved = ranks[0]["resume"]["saved"]
    tr, _ = _single()
    state, _, host = load_train_state(path, tr.init_state(9))
    assert host == {"epoch": 1} and state.step == 1
    for name, v in _params(tr.model).items():
        np.testing.assert_array_equal(v, saved[name])
    jtr = JaxTrainer(JaxTargetVAE(jcfg.ModelConfig.from_json(
        _config().to_json())), jcfg.TrainConfig(learning_rate=LR))
    jstate, _, _ = jax_load(path, jtr.init_state(9))
    np.testing.assert_array_equal(
        np.asarray(jstate.params["encoder"]["conv1"]["w"]),
        saved["encoder.conv1.w"])
    named = dict(tr.model.named_parameters())
    mu = jstate.opt_state.inner_state[0].mu
    for path, jv in jax.tree_util.tree_leaves_with_path(mu):
        name = _port_name(path)
        if "fourier" in name:
            continue
        got = state.optimizer.state[named[name]]["exp_avg"].numpy()
        assert got.shape == named[name].shape
        np.testing.assert_array_equal(got, np.asarray(jv))


def test_tp_resume_is_bitwise(tp_ranks):
    """Two sampled TP steps at once against one, a save, a load into a
    fresh sharded state and one more: the parameters and every rank's
    Adam moments bitwise; the loaded parameters are the saved ones."""
    _, ranks, _ = tp_ranks
    for r in ranks:
        res = r["resume"]
        assert res["step"] == 2
        for name, v in res["saved"].items():
            np.testing.assert_array_equal(res["loaded"][name], v)
        for name, v in res["full"]["params"].items():
            np.testing.assert_array_equal(res["resumed"]["params"][name], v)
        for i, mom in res["full"]["moments"].items():
            for k, v in mom.items():
                np.testing.assert_array_equal(
                    res["resumed"]["moments"][i][k], v)


def test_one_process_checkpoint_loads_sharded(tp_ranks):
    """A one-process resume file loads into a TP state: each rank's shards
    are its slices of the file's parameters and its Adam moments the
    slices of the file's, bitwise; the model holds the whole parameters."""
    _, ranks, one = tp_ranks
    ref = one["state"]
    named = dict(one["trainer"].model.named_parameters())
    for i, r in enumerate(ranks):
        got = r["one_process"]
        assert got["step"] == ref.step == 2
        for name, p in named.items():
            np.testing.assert_array_equal(got["params"][name],
                                          p.detach().numpy())
        assert len(got["shards"]) == len(named)
        for path, (axis, shard, moments) in got["shards"].items():
            name = path.replace("/", ".")
            name = "spatial_" + name if name.startswith("generator") else name
            t = i % 2
            cut = lambda v: (v if axis is None else np.take(
                v, range(t * shard.shape[axis], (t + 1) * shard.shape[axis]),
                axis=axis))
            np.testing.assert_array_equal(
                shard, cut(named[name].detach().numpy()))
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(
                    moments[k], cut(ref.optimizer.state[named[name]][k]
                                    .numpy()))
