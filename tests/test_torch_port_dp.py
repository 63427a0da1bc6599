"""The port's data axis and its weighted, CTF-carrying grid-sharded step on
CPU gloo ranks, against the JAX package and against one process.

- dp = 2: one deterministic float32 step on the JAX package's parameters
  against JAX's single-device loss and gradient; a ragged tail padded over
  the ranks against the unpadded tail; a ragged resident epoch and a
  streamed epoch against one process;
- SP (tp = 2, bf16) with CTF kernels and a zero-weight padded tail against
  the unsharded step;
- dp = 2 x tp = 2 SP on 4 ranks against the unsharded step;
- fit over 2 host-streamed ranks: one run directory, and a resume that
  equals the uninterrupted run bitwise.

Tolerances: float32 summed in other orders (the ranks' partial sums,
all-reduced) against one process at 1e-5 relative (metrics) and 1e-5
relative L2 (each gradient or parameter leaf), the bounds of
tests/test_torch_port_sp.py::test_sp_step_equals_single_process_step;
against the JAX package the bounds of
tests/test_torch_port_fit.py::test_weighted_elbo_and_gradient_match_jax
(rtol 2e-4 / atol 1e-4 on the values, 2e-4 relative L2 a gradient leaf).
The bf16 SP steps' gradients against the unsharded bf16 step: 1e-2
relative L2 a leaf, PERF.md section 2's SP bound (chip_smoke.TOL_SP_GRAD):
on the CPU the plain versions' bf16 weight-gradient products round their
outputs to bf16, so two ranks' partial sums of 2 rows differ from one
product over all rows by ~2e-3 (their metrics still agree to 1e-7). The
attention head's bias has an exact gradient of 0 (the joint softmax
ignores a shift of every logit), so both sides hold rounding noise there:
its parameter is held to Adam's bound, no move beyond the learning rate a
step, and its gradient to a floor of 1e-3 of the attention weight's.
The ranks are spawned once a module for each world size (hard timeouts);
they import only torch and the port.
"""

import numpy as np
import pytest
import torch

from targetvae_tpu_torch import ModelConfig
from targetvae_tpu_torch.data.ctf import ctf_filter
from targetvae_tpu_torch.train import Trainer, create_train_state
from targetvae_tpu_torch.utils.config import (
    EncoderConfig, GeneratorConfig, LikelihoodConfig, TrainConfig)

import torch_port_ranks
from torch_port_ranks import _clone, _grads, _params

SPAWN_TIMEOUT = 300
LR = 1e-3
SHIFT = "encoder.conv_a.b"   # the attention bias: an exact-zero gradient
SAMPLED = 3
TOL_SP_GRAD = 1e-2          # PERF.md section 2's SP gradient bound


def _config(d=14, hidden=32):
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=hidden, n_out=1,
                                  num_layers=2, fourier_expansion=True,
                                  fourier_sigma=2.0 / (d - 1),
                                  embedding_dim=64),
        encoder=EncoderConfig(image_dim=d, z_dim=2, kernels_num=16,
                              kernels_size=8, padding=3, groupconv=4),
        likelihood=LikelihoodConfig(kind="bernoulli"))


def _ctf_config(d=16):
    """tests/test_parallel.py::test_sp_particles_ctf_step_matches_single_
    device's particles model: Gaussian with CTF kernels and a mask."""
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=32, num_layers=1,
                                  fourier_expansion=False),
        encoder=EncoderConfig(image_dim=d, z_dim=2, kernels_num=8,
                              kernels_size=9, padding=4, groupconv=8),
        likelihood=LikelihoodConfig(kind="gaussian", use_ctf=True,
                                    mask_radius=5))


def _images(n, seed=0, d=14):
    return np.random.default_rng(seed).uniform(0, 1, (n, d, d, 1)).astype(
        np.float32)


def _ctf_batch(d=16):
    """Three particles and one zero-weight pad (a copy of the first), their
    CTF kernels (the port's ctf_filter over a defocus spread) and weights."""
    rng = np.random.RandomState(7)
    y = rng.randn(3, d, d, 1).astype(np.float32)
    full = lambda v: np.full(3, v)
    table = {"defocus": np.linspace(1.2, 1.8, 3), "cs": full(2.7),
             "voltage": full(300.0), "apix": full(1.2), "bfactor": full(100.0),
             "ampcont": full(10.0), "dfdiff": full(0.2), "dfang": full(30.0)}
    ctf = ctf_filter(table, d - 1, d - 1).astype(np.float32)
    pad = lambda v: np.concatenate([v, v[:1]])
    w = np.asarray([1 / 3] * 3 + [0.0], np.float32)
    return y, ctf, pad(y), pad(ctf), w


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _jax_params():
    """The JAX package's initial parameters of _config(), and the port's
    copy of them."""
    import jax
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.utils import config as jcfg
    from targetvae_tpu_torch.utils.jax_params import params_from_jax
    jc = jcfg.ModelConfig.from_json(_config().to_json())
    jm = JaxTargetVAE(jc)
    jp = jm.init(jax.random.key(0))
    return jc, jm, jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    from targetvae_tpu_torch.parallel.distributed import run_local
    _, _, _, params = _jax_params()
    y, ctf, yp, ctfp, w = _ctf_batch()
    inp = {"cfg": _config().to_json(), "lr": LR, "params": params,
           "y": _images(8, 1), "epoch_y": _images(10, 2),
           "sp_cfg": _ctf_config().to_json(),
           "sp": {"y": yp, "ctf": ctfp, "w": w},
           "fit_data": (_images(10, 3), _images(6, 4)),
           "root": str(tmp_path_factory.mktemp("dp_fit"))}
    return inp, run_local(torch_port_ranks.dp_work, 2, backend="gloo",
                          timeout=SPAWN_TIMEOUT, args=(inp,))


def _single(cfg, train_cfg, params=None):
    tr = Trainer(cfg, train_cfg, device="cpu")
    if params is None:
        state = tr.init_state(0)
        state.generator = None
    else:
        tr.model.load_params(_clone(params))
        state = create_train_state(tr.model, LR, None)
    return tr, state


def _close_params(got, ref, before, steps=1, tol=1e-5):
    for name, r in ref.items():
        if name == SHIFT:
            move = np.abs(got[name] - before[name]).max()
            assert move <= steps * LR * (1 + 1e-3), (name, move)
            continue
        assert _rel(got[name], r) <= tol, (name, _rel(got[name], r))


def _close_grads(got, ref, tol):
    floor = 1e-3 * np.linalg.norm(got["encoder.conv_a.w"])
    for name, r in ref.items():
        if name == SHIFT:
            assert np.linalg.norm(got[name]) <= floor, name
            continue
        assert _rel(got[name], r) <= tol, (name, _rel(got[name], r))


def test_dp_step_matches_jax_single_device(dp_ranks, monkeypatch):
    """One deterministic float32 step on 2 ranks (4 rows each) against the
    JAX package's single-device loss and gradient on the same 8 images
    and parameters (rtol 2e-4 / atol 1e-4, each gradient leaf at 2e-4
    relative L2, through the port's one-process step) and against the
    port's one-process step (1e-5); the ranks hold the same bits."""
    import jax
    import jax.numpy as jnp
    import targetvae_tpu.models.encoders as jax_enc
    from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
    from targetvae_tpu_torch.utils.jax_params import params_to_jax
    jc, jm, jp, _ = _jax_params()    # before the patch: init draws normals
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax_enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))
    inp, ranks = dp_ranks

    def loss(p):
        out = jax_compute_elbo(p, jc, jm.base_grid(), jnp.asarray(inp["y"]),
                               jax.random.key(1))
        return -out[0], out
    (_, ref), gref = jax.value_and_grad(loss, has_aux=True)(jp)
    a, b = (r["step"] for r in ranks)
    np.testing.assert_array_equal(a["metrics"], b["metrics"])
    np.testing.assert_allclose(a["metrics"], [float(v) for v in ref],
                               rtol=2e-4, atol=1e-4)
    tr, state = _single(_config(), TrainConfig(learning_rate=LR),
                        inp["params"])
    _, m = tr.train_step(state, inp["y"])
    np.testing.assert_allclose(a["metrics"], m.numpy(), rtol=1e-5)
    _close_grads(a["grads"], _grads(tr.model), 1e-5)
    # the JAX package's gradient against the one-process step's, mapped as
    # test_weighted_elbo_and_gradient_match_jax maps them
    p = tr.model.params()
    trained = {"encoder": p["encoder"], "generator": {
        k: v for k, v in p["generator"].items() if k != "fourier"}}
    ggot = params_to_jax(jax.tree.map(lambda t: t.grad, trained,
                                      is_leaf=torch.is_tensor))
    gref = {"encoder": gref["encoder"], "generator": {
        k: v for k, v in gref["generator"].items() if k != "fourier"}}
    for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(ggot),
                            jax.tree.leaves(gref)):
        if jax.tree_util.keystr(path) != "['encoder']['conv_a']['b']":
            assert _rel(np.asarray(g), np.asarray(r)) <= 2e-4, path
    for n in a["grads"]:
        np.testing.assert_array_equal(a["grads"][n], b["grads"][n])


def test_ragged_tail_padded_over_ranks_matches_unpadded(dp_ranks):
    """A tail of 5 padded to 6 over 2 ranks (a zero-weight copy of its
    first row; 1/5 on the real rows) gives the unpadded tail's batch-mean
    metrics and gradients (the JAX package's
    test_ragged_tail_padded_loss_and_grads_match_unpadded)."""
    inp, ranks = dp_ranks
    tail = ranks[0]["tail"]
    np.testing.assert_array_equal(tail["rows"], [0, 1, 2, 3, 4, 0])
    np.testing.assert_array_equal(tail["w"],
                                  np.float32([0.2] * 5 + [0.0]))
    tr, state = _single(_config(), TrainConfig(learning_rate=LR),
                        inp["params"])
    _, m = tr.train_step(state, inp["y"][:5])
    for r in ranks:
        np.testing.assert_allclose(r["tail"]["metrics"], m.numpy(),
                                   rtol=1e-5)
        _close_grads(r["tail"]["grads"], _grads(tr.model), 1e-5)


def test_ragged_epoch_on_two_ranks_matches_one(dp_ranks):
    """10 images at B = 4, deterministic and in order: two batches of 2
    rows a rank and the tail of 2 (1 a rank) equal one process's epoch
    (the JAX package's test_train_epoch_ragged_dataset_on_mesh_matches_
    single): the epoch's means at 1e-5 relative, parameters at 1e-5."""
    inp, ranks = dp_ranks
    tr, state = _single(_config(), TrainConfig(learning_rate=LR,
                                               minibatch_size=4))
    before = _params(tr.model)
    state, means = tr.train_epoch(state, inp["epoch_y"])
    for r in ranks:
        assert r["epoch"]["steps"] == state.step == 3
        np.testing.assert_allclose(r["epoch"]["means"], means, rtol=1e-5)
        _close_params(r["epoch"]["params"], _params(tr.model), before, 3)
    for name in before:
        np.testing.assert_array_equal(ranks[0]["epoch"]["params"][name],
                                      ranks[1]["epoch"]["params"][name])


def test_split_smaller_than_a_batch_runs_as_one_padded_tail(dp_ranks):
    """3 images at B = 4 on 2 ranks: one step on the 3 padded to 4 (a
    zero-weight row), equal to one process's step on the 3."""
    inp, ranks = dp_ranks
    tr, state = _single(_config(), TrainConfig(learning_rate=LR,
                                               minibatch_size=4))
    before = _params(tr.model)
    state, means = tr.train_epoch(state, inp["epoch_y"][:3])
    for r in ranks:
        assert r["small"]["steps"] == state.step == 1
        np.testing.assert_allclose(r["small"]["means"], means, rtol=1e-5)
        _close_params(r["small"]["params"], _params(tr.model), before)


def test_streamed_epoch_on_two_ranks_matches_one(dp_ranks):
    """A host-streamed epoch (10 images, B = 4, the tail wrapped around to
    4 with zero weights): each rank takes 2 rows of every batch, and the
    epoch equals one process streaming whole batches."""
    from targetvae_tpu_torch.data.pipeline import HostDataPipeline
    inp, ranks = dp_ranks
    tr, state = _single(_config(), TrainConfig(learning_rate=LR,
                                               minibatch_size=4))
    pipe = HostDataPipeline(inp["epoch_y"], batch_size=4, seed=3,
                            device="cpu")
    before = _params(tr.model)
    state, means = tr.train_epoch_stream(state, pipe.epoch(0))
    for r in ranks:
        assert r["stream"]["shapes"] == [(2, 14, 14, 1)] * 3
        np.testing.assert_allclose(r["stream"]["means"], means, rtol=1e-5)
        _close_params(r["stream"]["params"], _params(tr.model), before, 3)


def test_sp_ctf_weighted_step_matches_unsharded(dp_ranks):
    """SP (tp = 2, bf16) on the particles model with CTF kernels and the
    mask, the batch a tail of 3 padded to 4 with a zero-weight row: the
    metrics and every parameter after the step equal the unsharded bf16
    step on the 3 real rows and their kernels: metrics at 1e-5, gradients
    at the SP bound (the JAX package's
    test_sp_particles_ctf_step_matches_single_device)."""
    y, ctf, _, _, _ = _ctf_batch()
    tr, state = _single(_ctf_config(), TrainConfig(
        learning_rate=LR, compute_dtype="bfloat16"))
    _, m = tr.train_step(state, y, ctf=ctf)
    _, ranks = dp_ranks
    for r in ranks:
        np.testing.assert_allclose(r["sp"]["metrics"], m.numpy(), rtol=1e-5)
        _close_grads(r["sp"]["grads"], _grads(tr.model), TOL_SP_GRAD)
    for name, v in ranks[0]["sp"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["sp"]["params"][name], v)


def test_fit_on_two_ranks_writes_one_run_and_resumes_bitwise(dp_ranks):
    """fit over 2 host-streamed dp ranks: rank 0 alone writes, so each run
    root holds one run directory; 1 epoch, then a resume for 1 more, ends
    on the parameters of 2 epochs at once, bitwise, on both ranks."""
    import os
    inp, ranks = dp_ranks
    for name in ("full", "half", "resumed"):
        runs = os.listdir(os.path.join(inp["root"], name))
        assert runs == ["run"], (name, runs)
        assert "training_state.sav" in os.listdir(
            os.path.join(inp["root"], name, "run"))
    log = open(os.path.join(inp["root"], "full", "run",
                            "train_log.txt")).read()
    assert "# mesh: data=2 model=1 (2 ranks, gloo backend)" in log
    assert "# host-streaming train data (10 images; test 6)" in log
    for r in ranks:
        assert r["fit"]["steps"] == (6, 6)
        for name, v in r["fit"]["full"].items():
            np.testing.assert_array_equal(r["fit"]["resumed"][name], v)
    for name, v in ranks[0]["fit"]["full"].items():
        np.testing.assert_array_equal(ranks[1]["fit"]["full"][name], v)


@pytest.fixture(scope="module")
def dp_sp_ranks():
    from targetvae_tpu_torch.parallel.distributed import run_local
    from test_torch_port_sp import _images as sp_images
    from test_torch_port_sp import _model_config
    return run_local(torch_port_ranks.dp_sp_work, 4, backend="gloo",
                     timeout=SPAWN_TIMEOUT,
                     args=(_model_config().to_json(), sp_images(), LR,
                           SAMPLED))


def test_dp_sp_step_on_four_ranks_matches_unsharded(dp_sp_ranks):
    """dp = 2 x tp = 2 SP on 4 ranks (a data row's 2 images exchanged over
    its 2 model ranks): one deterministic step's metrics equal the
    unsharded bf16 step's at 1e-5 and its gradients within the SP bound;
    the ranks sit at (data, model) = (r // 2, r % 2); after 3 sampled
    steps they hold the same parameters bitwise and finite metrics."""
    from test_torch_port_sp import _images as sp_images
    from test_torch_port_sp import _model_config
    tr, state = _single(_model_config(), TrainConfig(
        learning_rate=LR, compute_dtype="bfloat16"))
    _, m = tr.train_step(state, sp_images())
    for i, r in enumerate(dp_sp_ranks):
        assert r["mesh"] == (i // 2, i % 2)
        np.testing.assert_allclose(r["det_metrics"], m.numpy(), rtol=1e-5)
        _close_grads(r["det_grads"], _grads(tr.model), TOL_SP_GRAD)
        assert r["sampled"].shape == (SAMPLED, 3)
        assert np.isfinite(r["sampled"]).all()
        np.testing.assert_array_equal(r["sampled"],
                                      dp_sp_ranks[0]["sampled"])
        for name, v in dp_sp_ranks[0]["params"].items():
            np.testing.assert_array_equal(r["params"][name], v)


def test_batch_rows_split_the_data_axis():
    """A rank's rows of a batch on a (2, 2) layout: under sp its data
    shard's, in rank order (the model axis splits them inside the step);
    without sp (tensor parallelism) its flattened shard's, d * 2 + t; a
    batch the ranks do not divide is refused."""
    import dataclasses
    from targetvae_tpu_torch.parallel.mesh import Mesh
    tr, _ = _single(_config(), TrainConfig())
    assert tr.batch_rows(6) == slice(0, 6)
    for d in range(2):
        tr._mesh = Mesh(data=2, model=2, data_index=d, rank=1, group=None,
                        data_group=None)
        for sp, rows in ((True, slice(4 * d, 4 * d + 4)),
                         (False, slice(4 * d + 2, 4 * d + 4))):
            tr.cfg = dataclasses.replace(tr.cfg, sp=sp)
            assert tr.batch_rows(8) == rows
            with pytest.raises(ValueError, match="does not split"):
                tr.batch_rows(6)


@pytest.mark.parametrize("world,local,cards,device,backend", [
    (2, 0, 1, "cuda:0", "gloo"), (2, 1, 1, "cuda:0", "gloo"),
    (2, 1, 2, "cuda:1", "nccl"), (4, 3, 4, "cuda:3", "nccl"),
    (2, 0, 0, "cpu", "gloo")])
def test_torchrun_environment_picks_device_and_backend(
        monkeypatch, world, local, cards, device, backend):
    """Under torchrun each local rank takes cuda:(LOCAL_RANK) where every
    rank has a card of its own, and then NCCL; ranks that share a card,
    or run on the CPU (-d -1), take gloo. The group joins through env://
    with torchrun's rank and world size."""
    from targetvae_tpu_torch.parallel import distributed as D
    env = {"RANK": str(local), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(local), "LOCAL_WORLD_SIZE": str(world),
           "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    joined = []
    monkeypatch.setattr(D, "initialize", lambda *a: joined.append(a))
    assert D.launched_by_torchrun()
    got = D.local_device(0 if device != "cpu" else -1)
    assert got == device
    assert D.initialize_from_env(got) == backend
    assert joined == [(backend, "env://", local, world, None)]


def test_multi_rank_cli_without_torchrun_names_it(monkeypatch, tmp_path):
    """A train CLI with --dp 2 outside torchrun exits naming the torchrun
    line, before it writes a run directory."""
    from targetvae_tpu_torch.cli import train_mnist
    from targetvae_tpu_torch.parallel import distributed as D
    for k in D.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    root = tmp_path / "mnist_U"
    root.mkdir()
    imgs = (np.random.default_rng(0).uniform(0, 255, (8, 14, 14))
            ).astype(np.uint8)
    for split in ("train", "test"):
        np.save(root / f"images_{split}.npy", imgs)
    with pytest.raises(SystemExit, match="torchrun --standalone "
                                         "--nproc_per_node 2"):
        train_mnist.main([
            "--dataset", "mnist-U", "--data-root", str(tmp_path),
            "--log-root", str(tmp_path / "logs"), "-d", "-1", "--dp", "2",
            "--image-dim", "14", "--encoder-kernel-number", "16",
            "--encoder-kernel-size", "8", "--encoder-padding", "3",
            "--generator-hidden-dim", "32", "--groupconv", "4",
            "--minibatch-size", "4", "--num-epochs", "1"])
    assert not (tmp_path / "logs").exists()
