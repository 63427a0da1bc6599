"""The port's checkpoints against the JAX package's: utils/msgpack.py against
flax's msgpack bytes, and inference.sav, generator.sav and
training_state.sav moving between the two packages both ways.

Every comparison feeds both packages the same numpy arrays. Tolerances:
parameters, Adam moments, steps and host state cross bitwise (float32 in,
float32 out); the two packages' embeds of one checkpoint agree within 1e-5
(float32 on both sides, summed in other orders).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.train import checkpoint as jax_ckpt
from targetvae_tpu.train.loop import Trainer as JaxTrainer
from targetvae_tpu.utils import config as jcfg

from targetvae_tpu_torch import ModelConfig
from targetvae_tpu_torch.cli.clustering_common import load_encoder
from targetvae_tpu_torch.train import Trainer, checkpoint
from targetvae_tpu_torch.utils import msgpack
from targetvae_tpu_torch.utils.config import TrainConfig

HOST = {"epoch": 3, "lr": 1e-4, "sched_best": -120.5, "sched_bad": 2,
        "early_best": -np.inf, "early_counter": 1}


def _config():
    """tests/test_torch_port_train.py's small config, with two hidden
    layers so that the generator's list holds more than one entry."""
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(z_dim=2, hidden_dim=32, n_out=1,
                                       num_layers=3, fourier_expansion=True,
                                       fourier_sigma=2.0 / 13,
                                       embedding_dim=64),
        encoder=jcfg.EncoderConfig(image_dim=14, z_dim=2, kernels_num=16,
                                   kernels_size=8, padding=3, groupconv=4),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


def _images(n=6, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 14, 14, 1)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX Trainer state after two steps (non-zero Adam moments)."""
    jc = _config()
    jm = JaxTargetVAE(jc)
    tr = JaxTrainer(jm, jcfg.TrainConfig(learning_rate=1e-3))
    state = tr.init_state(3)
    for i in range(2):
        state, _ = tr._train_step(state, jnp.asarray(_images(4, i)))
    return jm, tr, state


def _port_trainer(seed=5):
    cfg = ModelConfig.from_json(_config().to_json())
    tr = Trainer(cfg, TrainConfig(learning_rate=1e-3), device="cpu")
    state = tr.init_state(seed)
    for i in range(2):
        state, _ = tr.train_step(state, _images(4, 10 + i))
    return tr, state


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, tree))


def _assert_trees_equal(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


# ---- the codec against flax ----

def test_msgpack_bytes_equal_flax_for_a_model_pair(jax_run):
    jm, _, state = jax_run
    params = jax.tree.map(np.asarray, state.params)
    for sub in ("encoder", "generator"):
        payload = {"config": jm.cfg.to_json(), "step": 2,
                   "params": {sub: params[sub]}}
        blob = serialization.msgpack_serialize(payload)
        assert msgpack.packb(payload) == blob
        _assert_trees_equal(msgpack.unpackb(blob),
                            serialization.msgpack_restore(blob))


def test_msgpack_bytes_equal_flax_for_a_resume_payload(jax_run, tmp_path):
    """The payload the JAX package's AsyncCheckpointer writes: read back by
    the port's reader and written again by its writer, the file's bytes."""
    jm, _, state = jax_run
    path = str(tmp_path / "state.sav")
    ck = jax_ckpt.AsyncCheckpointer()
    ck.save(path, state, jm.cfg, host_state=HOST)
    ck.wait()
    blob = open(path, "rb").read()[len(checkpoint._MAGIC):]
    tree = msgpack.unpackb(blob)
    assert msgpack.packb(tree) == blob
    assert msgpack.packb(serialization.msgpack_restore(blob)) == blob
    _assert_trees_equal(tree, serialization.msgpack_restore(blob))


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63,
    0.5, -np.inf, "", "a" * 31, "b" * 32, "c" * 256, "é" * 70000, True,
    False, None, {}, [], list(range(20)), {str(i): i for i in range(20)},
    np.float32(1.5), np.int64(-3), np.bool_(True), np.asarray(-np.inf),
    np.zeros((0, 3), np.float32), np.arange(17, dtype=np.uint8),
    np.arange(70000, dtype=np.int32), np.zeros(2, np.uint32)],
    ids=lambda v: type(v).__name__)
def test_msgpack_values_match_flax(value):
    """Each wire form the writer chooses (fixed and sized ints, strs, maps,
    arrays, ext lengths) against flax's, and read back to flax's value."""
    tree = {"v": value}
    blob = serialization.msgpack_serialize(tree)
    assert msgpack.packb(tree) == blob
    got, ref = msgpack.unpackb(blob)["v"], serialization.msgpack_restore(blob)["v"]
    assert type(got) is type(ref)
    if isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def test_msgpack_refuses_what_it_does_not_implement():
    big = np.broadcast_to(np.zeros(1, np.uint8), (2 ** 30 + 1,))
    with pytest.raises(ValueError, match="chunks"):
        msgpack.packb({"a": big})
    chunked = serialization.msgpack_serialize(
        {"a": {"__msgpack_chunked_array__": True, "shape": [1]}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack.unpackb(chunked)
    with pytest.raises(TypeError):
        msgpack.packb({"a": (1, 2)})


# ---- the model pair, both ways ----

def test_port_model_pair_loads_in_jax(tmp_path):
    tr, state = _port_trainer()
    model = tr.model
    checkpoint.save_model_pair(str(tmp_path), model.params(), model.cfg,
                               step=state.step)
    jp, jc, payload = jax_ckpt.load_checkpoint(str(tmp_path / "inference.sav"))
    assert payload["step"] == 2 and jc.to_json() == model.cfg.to_json()
    y = _images(5, 3)
    ref = JaxTargetVAE(jc).embed(jax.tree.map(jnp.asarray, jp), jnp.asarray(y))
    with torch.inference_mode():
        got = model.embed(model.params(), torch.from_numpy(y))
    for name in ("z_content", "theta_mu", "dx"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    gp, _, _ = jax_ckpt.load_checkpoint(str(tmp_path / "generator.sav"))
    _assert_trees_equal(gp["generator"], jax.tree.map(
        lambda t: t.detach().numpy(), model.params()["generator"],
        is_leaf=torch.is_tensor))


def test_jax_model_pair_loads_in_port(jax_run, tmp_path):
    jm, _, state = jax_run
    jax_ckpt.save_model_pair(str(tmp_path), state.params, jm.cfg, step=2)
    model, params = load_encoder(str(tmp_path / "inference.sav"),
                                 device="cpu")
    assert model.cfg.to_json() == jm.cfg.to_json()
    y = _images(5, 4)
    ref = jm.embed(state.params, jnp.asarray(y))
    with torch.inference_mode():
        got = model.embed(params, torch.from_numpy(y))
    for name in ("z_content", "theta_mu", "dx"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    gp, _, _ = checkpoint.load_checkpoint(str(tmp_path / "generator.sav"))
    _assert_trees_equal(gp["generator"], state.params["generator"])


def test_load_encoder_refuses_a_reference_torch_sav(tmp_path):
    """A torch file is read as the reference's pickled inference network
    (utils/torch_import.py); one that holds no such network (here a dict)
    is refused with its class named, as the JAX package's encoder_from_sav
    refuses it."""
    path = str(tmp_path / "inference.sav")
    torch.save({"w": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="holds dict, not a reference "
                       "inference network"):
        load_encoder(path, device="cpu")


# ---- the resume file, both ways ----

def _port_moments(state, key):
    return [state.optimizer.state[p][key].numpy()
            for p in state.optimizer.param_groups[0]["params"]]


@pytest.mark.parametrize("writer", ["save_train_state", "AsyncCheckpointer"])
def test_jax_resume_file_loads_in_port(jax_run, tmp_path, writer):
    """Params, Adam's moments (the Fourier buffers', zero, left out), step,
    learning rate and host state equal the JAX state's, from either of the
    JAX package's writers; the noise is drawn fresh, and the log says
    so."""
    jm, _, state = jax_run
    path = str(tmp_path / "training_state.sav")
    if writer == "save_train_state":
        jax_ckpt.save_train_state(path, state, jm.cfg, host_state=HOST)
    else:
        ck = jax_ckpt.AsyncCheckpointer()
        ck.save(path, state, jm.cfg, host_state=HOST)
        ck.wait()
    tr = Trainer(ModelConfig.from_json(jm.cfg.to_json()),
                 TrainConfig(learning_rate=2e-4), device="cpu")
    lines = []
    got, cfg, host = checkpoint.load_train_state(path, tr.init_state(0),
                                                 log=lines.append)
    assert cfg.to_json() == jm.cfg.to_json()
    assert got.step == 2 and host == HOST
    assert got.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)
    _assert_trees_equal(jax.tree.map(lambda t: t.detach().numpy(),
                                     got.model.params(),
                                     is_leaf=torch.is_tensor), state.params)
    inner = state.opt_state.inner_state[0]
    no_fourier = lambda t: {"encoder": t["encoder"], "generator": {
        k: v for k, v in t["generator"].items() if k != "fourier"}}
    for key, ref in (("exp_avg", inner.mu), ("exp_avg_sq", inner.nu)):
        ref = [np.asarray(a) for a in jax.tree.leaves(no_fourier(ref))]
        got_m = dict(zip(map(id, got.optimizer.param_groups[0]["params"]),
                         _port_moments(got, key)))
        order = jax.tree.leaves(no_fourier(got.model.params()))
        for p, r in zip(order, ref):
            np.testing.assert_array_equal(got_m[id(p)], r)
    assert all(float(s["step"]) == 2 for s in got.optimizer.state.values())
    assert len(lines) == 1 and "fresh noise" in lines[0]
    tr.train_step(got, _images(4, 9))          # a step goes on from there


def test_port_resume_file_loads_in_jax(tmp_path):
    tr, state = _port_trainer()
    path = str(tmp_path / "training_state.sav")
    ck = checkpoint.AsyncCheckpointer()
    ck.save(path, state, tr.model.cfg, host_state=HOST)
    ck.wait()
    jm = JaxTargetVAE(_config())
    jtr = JaxTrainer(jm, jcfg.TrainConfig(learning_rate=2e-4))
    got, cfg, host = jax_ckpt.load_train_state(path, jtr.init_state(0))
    assert int(got.step) == 2
    assert {k: v.item() for k, v in host.items()} == HOST
    _assert_trees_equal(got.params, jax.tree.map(
        lambda t: t.detach().numpy(), tr.model.params(),
        is_leaf=torch.is_tensor))
    inner = got.opt_state.inner_state[0]
    assert int(inner.count) == 2 and int(got.opt_state.count) == 2
    lr = got.opt_state.hyperparams["learning_rate"]
    assert float(lr) == np.float32(1e-3)
    for key, ref in (("exp_avg", inner.mu), ("exp_avg_sq", inner.nu)):
        gen = dict(ref["generator"])
        assert not np.asarray(gen.pop("fourier")["w"]).any()
        leaves = jax.tree.leaves({"encoder": ref["encoder"],
                                  "generator": gen})
        params = jax.tree.leaves({"encoder": tr.model.params()["encoder"],
                                  "generator": {
            k: v for k, v in tr.model.params()["generator"].items()
            if k != "fourier"}})
        for p, r in zip(params, leaves):
            np.testing.assert_array_equal(
                state.optimizer.state[p][key].numpy(), np.asarray(r))
    jtr._train_step(got, jnp.asarray(_images(4, 9)))   # JAX goes on too


def test_port_resume_round_trip_is_bitwise(tmp_path):
    """A port file read back by the port: parameters, moments, step, the
    generator's state and the learning rate as they were saved."""
    tr, state = _port_trainer()
    path = str(tmp_path / "training_state.sav")
    checkpoint.save_train_state(path, state, tr.model.cfg, host_state=HOST)
    tr2 = Trainer(tr.model.cfg, TrainConfig(learning_rate=2e-4),
                  device="cpu")
    got, _, host = checkpoint.load_train_state(path, tr2.init_state(0))
    assert got.step == state.step and host == HOST
    assert torch.equal(got.generator.get_state(), state.generator.get_state())
    for p, q in zip(got.model.parameters(), tr.model.parameters()):
        assert torch.equal(p, q)
    for key in ("exp_avg", "exp_avg_sq"):
        for a, b in zip(_port_moments(got, key), _port_moments(state, key)):
            np.testing.assert_array_equal(a, b)
    assert got.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)


def test_save_snapshots_before_it_returns(tmp_path):
    """Adam updates the parameters in place after the save: the file holds
    the state as it was when save was called."""
    tr, state = _port_trainer()
    before = {id(p): p.detach().clone() for p in tr.model.parameters()}
    path = str(tmp_path / "training_state.sav")
    ck = checkpoint.AsyncCheckpointer()
    ck.save(path, state, tr.model.cfg, host_state=HOST)
    tr.train_step(state, _images(4, 7))
    ck.wait()
    params, _, payload = checkpoint.load_checkpoint(path)
    assert payload["step"] == 2
    now = jax.tree.leaves(tr.model.params(), is_leaf=torch.is_tensor)
    for t, saved in zip(now, jax.tree.leaves(params)):
        if id(t) in before:                     # the Fourier buffers stay
            np.testing.assert_array_equal(saved, before[id(t)].numpy())
            assert not np.array_equal(saved, t.detach().numpy())


def test_async_checkpointer_surfaces_a_failed_write(tmp_path):
    tr, state = _port_trainer()
    ck = checkpoint.AsyncCheckpointer()
    ck.save(str(tmp_path / "missing" / "s.sav"), state, tr.model.cfg)
    with pytest.raises(FileNotFoundError):
        ck.wait()
    ck.wait()                                   # the error is raised once
    assert not os.path.exists(tmp_path / "missing")
