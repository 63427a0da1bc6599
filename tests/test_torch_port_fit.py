"""The port's training harness against the JAX package's: the plateau and
early-stopping controllers, the run directory and its log, the metric
means, row-weighted ELBOs, the epoch loop and fit's controller order.

Each comparison feeds both packages the same inputs, made from a seed.
Controllers, names, logs and means must agree exactly; the row-weighted
ELBO and its gradient within the tolerances of
tests/test_torch_port_slice.py::test_elbo_matches_jax_with_zero_noise and
tests/test_torch_port_train.py::test_elbo_gradient_matches_jax (float32
summed in other orders: rtol 2e-4 / atol 1e-4 on the values, 2e-4 relative
L2 on each gradient leaf); the epoch loop equals its steps bitwise (the same
float32 operations on the CPU).
"""

import dataclasses
import math
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import targetvae_tpu.models.encoders as jax_enc
from targetvae_tpu.losses.elbo import compute_elbo as jax_compute_elbo
from targetvae_tpu.models import TargetVAE as JaxTargetVAE
from targetvae_tpu.train import fit as jax_fit
from targetvae_tpu.train import logging as jax_logging
from targetvae_tpu.train import loop as jax_loop
from targetvae_tpu.train import schedule as jax_schedule
from targetvae_tpu.utils import config as jcfg

from targetvae_tpu_torch import ModelConfig, TargetVAE
from targetvae_tpu_torch.losses.elbo import compute_elbo
from targetvae_tpu_torch.train import (EarlyStopping, ReduceLROnPlateau,
                                       RunLogger, Trainer, fit, run_dir_name)
from targetvae_tpu_torch.train import loop
from targetvae_tpu_torch.utils.config import TrainConfig
from targetvae_tpu_torch.utils.jax_params import params_from_jax, params_to_jax

RTOL, ATOL = 2e-4, 1e-4


def _config(hidden=32, image_dim=14):
    return jcfg.ModelConfig(
        generator=jcfg.GeneratorConfig(z_dim=2, hidden_dim=hidden, n_out=1,
                                       num_layers=2, fourier_expansion=True,
                                       fourier_sigma=2.0 / (image_dim - 1),
                                       embedding_dim=64),
        encoder=jcfg.EncoderConfig(image_dim=image_dim, z_dim=2,
                                   kernels_num=16, kernels_size=8, padding=3,
                                   groupconv=4),
        likelihood=jcfg.LikelihoodConfig(kind="bernoulli"))


def _images(n, seed=0, d=14):
    return np.random.default_rng(seed).uniform(0, 1, (n, d, d, 1)).astype(
        np.float32)


def _metric_sequence(seed, n=60):
    """A test-ELBO-like sequence: a noisy rise with plateaus and ties."""
    rng = np.random.default_rng(seed)
    steps = rng.choice([0.0, 0.0, 1e-5, 0.5, 2.0, -1.0], size=n)
    return [float(v) for v in np.round(-100 + np.cumsum(steps), 6)]


# ---- the controllers ----

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ["max", "min"])
def test_plateau_matches_jax(seed, mode):
    kw = dict(mode=mode, factor=0.5, patience=seed % 3, threshold=1e-4,
              min_lr=1e-6)
    ours, ref = ReduceLROnPlateau(1.0, **kw), jax_schedule.ReduceLROnPlateau(
        1.0, **kw)
    for m in _metric_sequence(seed):
        assert ours.step(m) == ref.step(m)
        assert (ours.best, ours.num_bad) == (ref.best, ref.num_bad)


@pytest.mark.parametrize("seed", range(4))
def test_plateau_matches_torch_scheduler(seed):
    """torch.optim.lr_scheduler.ReduceLROnPlateau with the reference's
    settings (mode max, absolute threshold, no cooldown), as
    tests/test_train.py::test_plateau_scheduler_matches_torch_semantics."""
    patience = seed % 3
    ours = ReduceLROnPlateau(1.0, mode="max", factor=0.5, patience=patience,
                             threshold=1e-4, min_lr=1e-3)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1.0)
    ref = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="max", factor=0.5, patience=patience, threshold=1e-4,
        threshold_mode="abs", cooldown=0, min_lr=1e-3)
    for m in _metric_sequence(seed):
        ref.step(m)
        assert ours.step(m) == pytest.approx(opt.param_groups[0]["lr"])


@pytest.mark.parametrize("seed", range(4))
def test_early_stopping_matches_jax(seed):
    saves = {"ours": 0, "ref": 0}
    ours = EarlyStopping(patience=5, delta=1e-4,
                         save_fn=lambda: saves.__setitem__(
                             "ours", saves["ours"] + 1))
    ref = jax_schedule.EarlyStopping(
        patience=5, delta=1e-4,
        save_fn=lambda: saves.__setitem__("ref", saves["ref"] + 1))
    for m in _metric_sequence(seed):
        assert ours(m) == ref(m)
        assert (ours.counter, ours.max_elbo, ours.early_stop) == (
            ref.counter, ref.max_elbo, ref.early_stop)
        assert saves["ours"] == saves["ref"]


# ---- the run directory and its log ----

@pytest.mark.parametrize("kw", [
    dict(dataset="mnist-U", z_dim=2, t_inf="attention",
         r_inf="attention+offsets", groupconv=8),
    dict(dataset="mnist-N", z_dim=5, t_inf="unimodal", r_inf="unimodal"),
    dict(dataset="galaxy", z_dim=2, t_inf="attention", r_inf="attention",
         groupconv=16, extra_tags=["ctf", "noise"]),
    dict(dataset="mnist", z_dim=2, t_inf="attention", r_inf="unimodal",
         groupconv=0, timestamp="2026-01-02-03-04")])
def test_run_dir_name_matches_jax(kw):
    kw = dict(kw, timestamp=kw.get("timestamp", "2026-10-17-12-00"))
    assert run_dir_name(**kw) == jax_logging.run_dir_name(**kw)


def test_run_logger_matches_jax(tmp_path, capsys):
    """train_log.txt byte for byte, and the same stdout and stderr, for a
    new run and for a run appended to on resume."""
    outs = {}
    for name, cls in (("ours", RunLogger), ("ref", jax_logging.RunLogger)):
        root = str(tmp_path / name)
        for append in (False, True):
            lg = cls(root, "run", args_repr="Namespace(a=1)",
                     model_repr='{"m": 2}', append=append)
            lg.epoch(1, "train", -101.25, 90.5, 10.75)
            lg.line("#ELBO increased -inf: --> -101.2500.  Saving model ...")
            lg.progress("# epoch 1: 0.50s, 200 images/sec")
            assert lg.path_prefix == os.path.join(root, "run", "")
            lg.close()
        outs[name] = (open(os.path.join(root, "run", "train_log.txt"),
                           "rb").read(), capsys.readouterr())
    assert outs["ours"] == outs["ref"]


# ---- the metric means ----

def test_weighted_and_streaming_means_match_jax():
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(k, 3)) for k in (3, 1, 2)]
    weights = [100.0] * 5 + [37.0]
    assert loop._weighted_mean(np.concatenate(blocks), weights) == \
        jax_loop._weighted_mean(np.concatenate(blocks), weights)
    for i in range(1, 4):
        w = weights[:sum(len(b) for b in blocks[:i])]
        assert loop._streaming_means(blocks[:i], w) == \
            jax_loop._streaming_means(blocks[:i], w)


# ---- row weights through the ELBO ----

@pytest.fixture
def zero_noise(monkeypatch):
    """The JAX side without sampling noise (tests/test_elbo.py's recipe);
    the port's counterpart is generator=None."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax_enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))


def _padded_tail():
    """Four real rows and two zero-weight pads repeating the first, the
    layout of Trainer._pad_tail on a mesh of 3 ranks."""
    y = _images(4, 2)
    yp = np.concatenate([y, y[:1], y[:1]])
    w = np.asarray([0.25] * 4 + [0.0] * 2, np.float32)
    return y, yp, w


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def test_weighted_elbo_and_gradient_match_jax(zero_noise):
    jc = _config()
    jm = JaxTargetVAE(jc)
    jp = jm.init(jax.random.key(0))
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    y, yp, w = _padded_tail()

    def jax_loss(p):
        out = jax_compute_elbo(p, jc, jm.base_grid(), jnp.asarray(yp),
                               jax.random.key(1), row_weights=jnp.asarray(w))
        return -out[0], out
    (_, ref), gref = jax.value_and_grad(jax_loss, has_aux=True)(jp)
    params = tm.params()
    got = compute_elbo(params, tm.cfg, tm.base_grid(), torch.from_numpy(yp),
                       None, row_weights=torch.from_numpy(w))
    np.testing.assert_allclose([float(t.detach()) for t in got],
                               [float(t) for t in ref], rtol=RTOL, atol=ATOL)
    (-got[0]).backward()
    trained = {"encoder": params["encoder"], "generator": {
        k: v for k, v in params["generator"].items() if k != "fourier"}}
    ggot = params_to_jax(jax.tree.map(lambda p: p.grad, trained,
                                      is_leaf=torch.is_tensor))
    gref = {"encoder": gref["encoder"], "generator": {
        k: v for k, v in gref["generator"].items() if k != "fourier"}}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ggot),
                            jax.tree.leaves(gref)):
        b = np.asarray(b)
        if jax.tree_util.keystr(path) == "['encoder']['conv_a']['b']":
            continue        # the softmax's shift direction: rounding noise
        assert _rel(a, b) <= 2e-4, path
    # the weighted padded batch is the mean over its real rows
    with torch.inference_mode():
        plain = compute_elbo(tm.params(), tm.cfg, tm.base_grid(),
                             torch.from_numpy(y), None)
    np.testing.assert_allclose([float(t.detach()) for t in got],
                               [float(t) for t in plain], rtol=1e-5)


def test_weighted_elbo_on_the_bf16_tier_tracks_f32():
    """The kernel tier's branches (K3's per-image KL dotted with the
    weights, K7's decode through reconstruct_log_prob; hidden 64 is a pose
    kernel width) on their plain versions: the weighted bf16 ELBO tracks
    the weighted float32 one to the 2e-2 bf16-operand bound of
    test_bf16_kernel_tier_tracks_f32_tier, equals its own mean over the
    real rows, and None leaves the unweighted value as it was."""
    jc = _config(hidden=64)
    tm = TargetVAE(ModelConfig.from_json(jc.to_json()), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    y, yp, w = _padded_tail()
    args = (tm.params(), tm.cfg, tm.base_grid())
    with torch.inference_mode():
        e16 = compute_elbo(*args, torch.from_numpy(yp), None, torch.bfloat16,
                           row_weights=torch.from_numpy(w))
        e32 = compute_elbo(*args, torch.from_numpy(yp), None,
                           row_weights=torch.from_numpy(w))
        m16 = compute_elbo(*args, torch.from_numpy(y), None, torch.bfloat16)
        n16 = compute_elbo(*args, torch.from_numpy(y), None, torch.bfloat16,
                           row_weights=None)
    for a, b, c, d in zip(e16, e32, m16, n16):
        assert abs(float(a) - float(b)) <= 2e-2 * abs(float(b)) + 1e-3
        assert float(a) == pytest.approx(float(c), rel=1e-5, abs=1e-5)
        assert torch.equal(c, d)


# ---- the epoch loop ----

def _trainer(batch=100, lr=1e-3, seed=4, hidden=32):
    cfg = ModelConfig.from_json(_config(hidden=hidden).to_json())
    tr = Trainer(cfg, TrainConfig(learning_rate=lr, minibatch_size=batch),
                 device="cpu")
    return tr, tr.init_state(seed)


def test_train_epoch_equals_its_train_steps():
    """250 images at B=100: the epoch is the steps on batches 0-99 and
    100-199 of torch.randperm drawn from the state's generator, then the
    50-image tail, in that order; parameters, moments and the metrics'
    means equal. Metrics are read per chunk: with progress_chunk 1 the
    callback sees the first batch's means once the second is queued."""
    data = _images(250, 7)
    tr, st = _trainer()
    tr.progress_chunk = 1
    seen = []
    st, means = tr.train_epoch(st, data,
                               progress=lambda c, *m: seen.append((c, m)))
    ref_tr, ref = _trainer()
    perm = torch.randperm(250, generator=ref.generator)
    ms = []
    for idx in (perm[:100], perm[100:200], perm[200:]):
        ref, m = ref_tr.train_step(ref, torch.from_numpy(data)[idx])
        ms.append(m.numpy())
    assert st.step == ref.step == 3
    for p, q in zip(tr.model.parameters(), ref_tr.model.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(st.optimizer.state.values(), ref.optimizer.state.values()):
        assert torch.equal(p["exp_avg_sq"], q["exp_avg_sq"])
    assert means == loop._weighted_mean(np.stack(ms), [100.0, 100.0, 50.0])
    assert seen == [(100, loop._weighted_mean(ms[0][None], [100.0]))]


def test_eval_epoch_equals_its_eval_steps():
    """Batches in order, the tail as a smaller batch, noise from one
    generator seeded `seed` (the JAX package's key(seed))."""
    data = _images(130, 8)
    tr, st = _trainer(batch=50)
    got = tr.eval_epoch(st, data, seed=3)
    gen = torch.Generator().manual_seed(3)
    ms = [tr.eval_step(st, data[i:i + 50], gen).numpy()
          for i in (0, 50, 100)]
    assert got == loop._weighted_mean(np.stack(ms), [50.0, 50.0, 30.0])
    assert tr.eval_epoch(st, data, seed=3) == got


def test_pad_tail_matches_jax():
    """Without a mesh the tail stays as it is (no weights); over ranks it is
    padded with zero-weight copies of its first row to a multiple of the
    mesh's size (data x model ranks), as the JAX package pads."""
    tr, _ = _trainer()
    jtr = jax_loop.Trainer(JaxTargetVAE(_config()), jcfg.TrainConfig())
    tail = torch.arange(7, 12)
    got, w = tr._pad_tail(tail, 5)
    assert w is None and torch.equal(got, tail)
    tr._mesh = types.SimpleNamespace(data=2, model=2, size=4)
    jtr._mesh = types.SimpleNamespace(size=4)
    got, w = tr._pad_tail(tail, 5)
    ref, rw = jtr._pad_tail(jnp.arange(7, 12), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))


# ---- fit ----

def _logger(tmp_path, name):
    return RunLogger(str(tmp_path), name)


@pytest.fixture(scope="module")
def fit_ranks(tmp_path_factory):
    """fit on 2 gloo ranks for one epoch: dp = 2 (float32), tp = 2 (float32,
    the parameters sharded) and sp with tp = 2 (bf16), each rank 2 of the 4
    images under dp and tp (sp: the data row's 4); a spawn for each."""
    from targetvae_tpu_torch.parallel.distributed import run_local
    import torch_port_ranks
    cfg = _config().to_json()
    out = {}
    for field, kw in (("dp", {"dp": 2}), ("tp", {"tp": 2}),
                      ("sp", {"sp": True, "tp": 2,
                              "compute_dtype": "bfloat16"})):
        root = str(tmp_path_factory.mktemp(field))
        out[field] = run_local(
            torch_port_ranks.fit_one_epoch, 2, backend="gloo", timeout=300,
            args=(cfg, dict(kw, minibatch_size=4), root,
                  (_images(4), _images(4))))
    return out


@pytest.mark.parametrize("field,value,item", [
    ("host_stream", True, "item 22"), ("stream_bf16", True, "item 22"),
    ("dp", 2, "item 23"), ("tp", 2, "item 23"), ("sp", True, "item 24"),
    ("ctf", None, "item 19")])
def test_fit_refuses_what_is_not_ported(tmp_path, field, value, item,
                                        fit_ranks):
    """fit runs each field whose ROADMAP item is ported: the host feed
    (item 22: host_stream, and stream_bf16, which without host_stream is
    noted and ignored), dp > 1 (item 23's data axis) and sp (item 24) on 2
    gloo ranks, TP parameter sharding (tp without sp, item 23) likewise,
    and the per-image CTF kernels (item 19) on a Gaussian CTF config: one
    epoch each with finite metrics, the item's refusal gone from the
    log."""
    cfg = ModelConfig.from_json(_config().to_json())
    data = _images(4)
    if field in ("dp", "tp", "sp"):
        ranks = fit_ranks[field]
        log = ranks[0]["log"]
        assert ranks[1]["log"] is None and [r["step"] for r in ranks] == [1, 1]
        for name, v in ranks[0]["params"].items():
            np.testing.assert_array_equal(ranks[1]["params"][name], v)
    else:
        kw, ctf = {"minibatch_size": 4, "num_epochs": 1}, {}
        if field == "ctf":
            cfg = dataclasses.replace(cfg, likelihood=dataclasses.replace(
                cfg.likelihood, kind="gaussian", use_ctf=True))
            kernels = np.random.default_rng(1).normal(
                size=(4, 13, 13)).astype(np.float32) * 0.05
            ctf = {"ctf_train": kernels, "ctf_test": kernels}
        else:
            kw[field] = value
        lg = _logger(tmp_path, "run")
        state = fit(TargetVAE(cfg, device="cpu"), TrainConfig(**kw), lg,
                    data, data, **ctf)
        lg.close()
        log = open(os.path.join(lg.path_prefix, "train_log.txt")).read()
        assert state.step == 1
        if field == "host_stream":
            assert "# host-streaming train data (4 images; test 4)" in log
        if field == "stream_bf16":
            assert "--stream-bf16 only affects --host-stream runs" in log
    assert item not in log
    rows = [l.split("\t") for l in log.splitlines()
            if "\ttrain\t" in l or "\ttest\t" in l]
    assert len(rows) == 2
    assert all(np.isfinite([float(v) for v in r[2:]]).all() for r in rows)


def _controller_lines(path):
    keep = ("#EarlyStopping", "# reducing", "*** Early", "#ELBO increased")
    out = []
    for line in open(path):
        if line.startswith(keep):
            out.append(line.split(" -->")[0].split(" -inf")[0].strip())
    return out


def test_fit_runs_the_controllers_in_the_jax_order(tmp_path):
    """A threshold and a delta no epoch can beat: every epoch after the
    first is 'bad'. The plateau halves the LR every second bad epoch and
    early stopping ends the run after three; the same lines, files and
    epochs as the JAX package's fit on the same data and config."""
    d = 12
    data = (_images(30, 1, d), _images(10, 2, d))
    train = dict(learning_rate=1e-3, minibatch_size=20, num_epochs=8,
                 save_interval=2, plateau_patience=1, plateau_threshold=1e9,
                 early_patience=3, early_delta=1e9)
    jc = _config(image_dim=d)
    for name in ("ours", "ref"):
        lg = (RunLogger if name == "ours" else jax_logging.RunLogger)(
            str(tmp_path / name), "run")
        if name == "ours":
            state = fit(TargetVAE(ModelConfig.from_json(jc.to_json()),
                                  device="cpu"), TrainConfig(**train), lg,
                        *data)
            assert state.step == 4 * 2
            assert state.optimizer.param_groups[0]["lr"] == 5e-4
        else:
            jax_fit(JaxTargetVAE(jc), jcfg.TrainConfig(**train), lg,
                            *map(jnp.asarray, data))
        lg.close()
    run = lambda n: str(tmp_path / n / "run")
    assert sorted(os.listdir(run("ours"))) == sorted(os.listdir(run("ref")))
    ours = _controller_lines(os.path.join(run("ours"), "train_log.txt"))
    assert ours == _controller_lines(os.path.join(run("ref"),
                                                  "train_log.txt"))
    assert ours[-1] == "*** Early stopping ***" and len(ours) == 6
    assert not math.isnan(sum(float(l.split("\t")[2]) for l in open(
        os.path.join(run("ours"), "train_log.txt")) if "\ttest\t" in l))
