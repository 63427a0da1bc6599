"""The port's host feed (data/pipeline.py) and streamed epochs
(Trainer.train_epoch_stream, eval_epoch_stream) against the JAX package's
on the CPU.

- batches: bitwise the JAX package's HostDataPipeline batches (order, y,
  ctf, w, n_real) for seeds 0-2 on the float32 and the bf16 wire, at a
  ragged N;
- a worker's error surfaces in the consumer; a consumer that stops early
  leaves no thread behind; a rank's rows concatenate to the global batch;
- the streamed epoch equals its train_steps bitwise (the same float32
  operations); the streamed eval matches the JAX package's under no
  sampling noise at rtol 1e-5 (float32 summed in other orders).
"""

import threading

import numpy as np
import pytest
import torch

from targetvae_tpu_torch import ModelConfig
from targetvae_tpu_torch.data import native
from targetvae_tpu_torch.data.pipeline import HostDataPipeline, StreamBatch
from targetvae_tpu_torch.train import Trainer
from targetvae_tpu_torch.train import loop
from targetvae_tpu_torch.utils.config import (
    EncoderConfig, GeneratorConfig, LikelihoodConfig, TrainConfig)

N, B = 53, 16      # three full batches and a tail of 5


def _data(seed=0, n=N, d=8, kc=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, d, d, 1).astype(np.float32),
            rng.rand(n, kc, kc).astype(np.float32))


def _config():
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=32),
        encoder=EncoderConfig(image_dim=12, z_dim=2, kernels_num=16,
                              kernels_size=7, padding=2, groupconv=4),
        likelihood=LikelihoodConfig())


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, 12, 12, 1).astype(np.float32)


def _threads():
    return [t for t in threading.enumerate()
            if t.name == "HostDataPipeline" and t.is_alive()]


@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_batches_equal_the_jax_pipeline(seed, wire):
    """Same seed, same epoch: the same order (RandomState(seed + epoch)),
    the same rows of y and of the CTF kernels (on the bf16 wire the same
    host rounding), the same weights (1/B; the tail's 1/5 over its real
    rows, zeros over the wrap-around pads) and n_real."""
    from targetvae_tpu.data.pipeline import HostDataPipeline as JaxPipeline
    y, ctf = _data(seed)
    ours = HostDataPipeline(y, ctf, batch_size=B, seed=seed, device="cpu",
                            wire_dtype=wire)
    ref = JaxPipeline(y, ctf, batch_size=B, seed=seed, wire_dtype=wire)
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 4
        assert [b.n_real for b in got] == [16, 16, 16, 5]
        for a, b in zip(got, want):
            assert isinstance(a, StreamBatch)
            assert a.y.dtype == (torch.bfloat16 if wire else torch.float32)
            np.testing.assert_array_equal(a.y.float().numpy(),
                                          np.asarray(b.y, np.float32))
            np.testing.assert_array_equal(a.ctf.float().numpy(),
                                          np.asarray(b.ctf, np.float32))
            np.testing.assert_array_equal(a.w.numpy(), np.asarray(b.w))
            assert a.n_real == b.n_real
    order = ours.order(1)
    np.testing.assert_array_equal(
        order, np.random.RandomState(seed + 1).permutation(N))
    tail = list(ours.epoch(1))[-1]
    np.testing.assert_array_equal(tail.y[5:10].float().numpy(),
                                  tail.y[:5].float().numpy())


def test_shuffle_false_streams_in_order():
    y, _ = _data()
    pipe = HostDataPipeline(y, batch_size=B, device="cpu", shuffle=False)
    got = torch.cat([b.y[:b.n_real] for b in pipe.epoch(3)])
    np.testing.assert_array_equal(got.numpy(), y)


def test_worker_error_surfaces(monkeypatch):
    """A failure in the worker thread raises in the consumer (a crash must
    not look like a short epoch), chained to the worker's exception (the
    JAX package's test_pipeline_worker_error_surfaces)."""
    y, _ = _data()
    pipe = HostDataPipeline(y, batch_size=B, device="cpu")
    calls = {"n": 0}
    orig = native.gather_f32

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk went away")
        return orig(*a, **kw)
    monkeypatch.setattr(native, "gather_f32", flaky)
    seen = []
    with pytest.raises(RuntimeError, match="worker failed") as info:
        for b in pipe.epoch(0):
            seen.append(b)
    assert isinstance(info.value.__cause__, OSError)
    assert len(seen) == 1 and not _threads()


def test_consumer_that_stops_leaves_no_thread():
    """Closing the epoch's generator mid-epoch (the worker blocked on a
    full queue) stops and joins the worker."""
    y, ctf = _data()
    pipe = HostDataPipeline(y, ctf, batch_size=4, device="cpu", prefetch=1)
    it = pipe.epoch(0)
    next(it)
    assert len(_threads()) == 1
    it.close()
    assert not _threads()
    for _ in pipe.epoch(0):
        break
    assert not _threads()


def test_rank_rows_concatenate_to_the_global_batch():
    """Two ranks' pipelines (rows 0-7 and 8-15 of every batch) hold, side
    by side, the one-process pipeline's batches, weights included; n_real
    counts the global batch."""
    y, ctf = _data(1)
    whole = list(HostDataPipeline(y, ctf, batch_size=B, seed=4,
                                  device="cpu").epoch(2))
    parts = [list(HostDataPipeline(y, ctf, batch_size=B, seed=4,
                                   device="cpu", rows=rows).epoch(2))
             for rows in (slice(0, 8), slice(8, 16))]
    for w, a, b in zip(whole, *parts):
        for field in ("y", "ctf", "w"):
            torch.testing.assert_close(
                torch.cat([getattr(a, field), getattr(b, field)]),
                getattr(w, field), rtol=0, atol=0)
        assert a.n_real == b.n_real == w.n_real
    assert float(parts[1][-1].w.sum()) == 0.0      # all pads on rank 1


def test_native_and_numpy_gathers_stream_the_same_batches():
    y, ctf = _data(2)
    a = list(HostDataPipeline(y, ctf, batch_size=B, seed=1,
                              device="cpu").epoch(0))
    b = list(HostDataPipeline(y, ctf, batch_size=B, seed=1, device="cpu",
                              native=False).epoch(0))
    for p, q in zip(a, b):
        assert torch.equal(p.y, q.y) and torch.equal(p.ctf, q.ctf)


def _trainer(seed=0):
    tr = Trainer(_config(), TrainConfig(learning_rate=1e-3,
                                        minibatch_size=B), device="cpu")
    return tr, tr.init_state(seed)


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_train_epoch_stream_equals_its_train_steps(wire):
    """The streamed epoch is its train_steps on the pipeline's batches and
    weights, in order, from the same generator: parameters, Adam's moments
    and the epoch's means (each step weighing its n_real) equal bitwise.
    With progress_chunk 1 the callback sees each batch's means once the
    next is queued."""
    images = _images(N, 2)
    pipe = HostDataPipeline(images, batch_size=B, seed=5, device="cpu",
                            wire_dtype=wire)
    tr, st = _trainer()
    tr.progress_chunk = 1
    seen = []
    st, means = tr.train_epoch_stream(
        st, pipe.epoch(1), progress=lambda c, *m: seen.append(c))
    ref_tr, ref = _trainer()
    ms = []
    for b in pipe.epoch(1):
        ref, m = ref_tr.train_step(ref, b.y, b.w, b.ctf)
        ms.append(m.numpy())
    assert st.step == ref.step == 4
    for p, q in zip(tr.model.parameters(), ref_tr.model.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(st.optimizer.state.values(), ref.optimizer.state.values()):
        assert torch.equal(p["exp_avg_sq"], q["exp_avg_sq"])
    assert means == loop._weighted_mean(np.stack(ms), [16.0] * 3 + [5.0])
    assert seen == [16, 32, 48]
    assert all(np.isfinite(means))


def test_eval_epoch_stream_matches_jax(monkeypatch):
    """Under no sampling noise (the JAX package's zero_noise recipe; the
    port's seed=None) the streamed eval over a ragged test split equals the
    JAX package's eval_epoch_stream on the same parameters at rtol 1e-5,
    and the port's resident eval_epoch on the same rows."""
    import jax
    import jax.numpy as jnp
    import targetvae_tpu.models.encoders as jax_enc
    from targetvae_tpu.data.pipeline import HostDataPipeline as JaxPipeline
    from targetvae_tpu.models import TargetVAE as JaxTargetVAE
    from targetvae_tpu.train import loop as jax_loop
    from targetvae_tpu.utils import config as jcfg
    from targetvae_tpu_torch.utils.jax_params import params_from_jax
    jc = jcfg.ModelConfig.from_json(_config().to_json())
    jm = JaxTargetVAE(jc)
    jtr = jax_loop.Trainer(jm, jcfg.TrainConfig(minibatch_size=B))
    jstate = jtr.init_state(0)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(jax_enc, "gumbel_softmax",
                        lambda key, logits, tau=1.0, axis=-1:
                        jax.nn.softmax(logits, axis=axis))
    images = _images(N, 3)
    ref = jtr.eval_epoch_stream(jstate, JaxPipeline(
        images, batch_size=B, shuffle=False).epoch(0), seed=0)
    tr, st = _trainer()
    tr.model.load_params(params_from_jax(jax.tree.map(np.asarray,
                                                      jstate.params)))
    pipe = HostDataPipeline(images, batch_size=B, device="cpu",
                            shuffle=False)
    got = tr.eval_epoch_stream(st, pipe.epoch(0), seed=None)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    resident = loop._weighted_mean(np.stack([
        tr.eval_step(st, images[i:i + B]).numpy()
        for i in range(0, N, B)]), [16.0] * 3 + [5.0])
    np.testing.assert_allclose(got, resident, rtol=1e-5)


def test_bare_pairs_stream_as_whole_batches():
    """A bare (y, ctf) iterator (the JAX package's ad-hoc feed) runs as
    unweighted batches, each weighing its rows."""
    images = _images(32, 4)
    tr, st = _trainer()
    ref_tr, ref = _trainer()
    st, means = tr.train_epoch_stream(
        st, [(images[:16], None), (images[16:], None)])
    ms = [ref_tr.train_step(ref, images[i:i + 16])[1].numpy()
          for i in (0, 16)]
    assert means == loop._weighted_mean(np.stack(ms), [16.0, 16.0])
