"""The port's grid-sharded (sequence-parallel) posterior and SP training step
against the JAX package on the CPU.

- K5/K6's plain versions against JAX's posterior_shard_partials, called
  directly in interpret mode;
- parallel/grid_softmax.py::sp_posterior_kernel over 2 gloo ranks against
  JAX's under shard_map on 2 virtual CPU devices (interpret mode), as
  tests/test_grid_softmax.py runs it, and its -1e30 padding case;
- the SP Trainer (bf16 tier, tp=2, sp=True) on 2 gloo ranks against the
  single-process step, and its configuration checks.

The ranks are spawned once for the module (the `ranks` fixture, a hard
timeout), so a hung rank fails a test instead of running the suite out of
time. They import only torch and the port: JAX is imported inside the test
functions. Inputs are made with numpy from seeds and handed to both sides.
"""

import numpy as np
import pytest
import torch

from targetvae_tpu_torch import ModelConfig
from targetvae_tpu_torch.kernels.posterior import (
    posterior_shard_bwd_plain, posterior_shard_partials, posterior_shard_plain)
from targetvae_tpu_torch.train import Trainer
from targetvae_tpu_torch.utils.config import (
    EncoderConfig, GeneratorConfig, LikelihoodConfig, TrainConfig)

T = 2                 # ranks
SPAWN_TIMEOUT = 300   # seconds for the module's one spawn, all ranks
SAMPLED_STEPS = 3
LR = 2e-4


def _log_softmax(x):
    m = x.max()
    return (x - m - np.log(np.exp(x - m).sum())).astype(np.float32)


def _shard_inputs(B, C, zd, seed):
    """attn, noise (B, C), th (B, 2, C), z (B, 2, zd, C), p, gx, gy, offs (C,)
    as tests/test_grid_softmax.py draws them, from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    u = np.clip(rng.uniform(size=(B, C)), 1e-20, 1 - 1e-7)
    noise = (-np.log(-np.log(u))).astype(np.float32)
    return (f(B, C) * 2, noise, f(B, 2, C) * 0.5, f(B, 2, zd, C) * 0.5,
            _log_softmax(f(C)), f(C), f(C), f(C) * 0.3)


def _padded_inputs(B=2, C=4096, zd=1, live=1500):
    """tests/test_grid_softmax.py:151-212's case: cells live.. are pads."""
    rng = np.random.default_rng(1)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    attn = f(B, C)
    attn[:, live:] = -1e30
    p = _log_softmax(np.where(np.arange(C) < live, 0.0, -1e30))
    zeros = np.zeros((C,), np.float32)
    return (attn, np.zeros((B, C), np.float32), f(B, 2, C) * 0.3,
            f(B, 2, zd, C) * 0.3, p, zeros, zeros, zeros)


# the sp_posterior_kernel cases: (inputs, sig_r, loss of the output)
SP_CASES = {"random": (lambda: _shard_inputs(3, 4096, 2, 0),
                       float(np.pi / 4), "sin"),
            "padded": (_padded_inputs, 1.0, "sum")}


def _model_config():
    """A small mode-C model: 18x18 images, K=8, P4, hidden 64, F=64; its
    17 x 17 x 4 = 1,156 cells pad to 2,048, so each rank's shard holds
    live cells and rank 1's also pads."""
    d = 18
    return ModelConfig(
        generator=GeneratorConfig(z_dim=2, hidden_dim=64, n_out=1,
                                  num_layers=2, fourier_expansion=True,
                                  fourier_sigma=2.0 / (d - 1),
                                  embedding_dim=64),
        encoder=EncoderConfig(image_dim=d, z_dim=2, kernels_num=8,
                              kernels_size=8, padding=3, groupconv=4),
        likelihood=LikelihoodConfig(kind="bernoulli"))


def _images(n=4, d=18):
    return np.random.default_rng(2).uniform(0, 1, (n, d, d, 1)).astype(
        np.float32)


def _sp_config(**kw):
    return TrainConfig(**{"learning_rate": LR, "compute_dtype": "bfloat16",
                          "tp": T, "sp": True, **kw})


def _counting(module, names):
    """Wrap module-level functions so the rank can tell which ran."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        setattr(module, name, wrapped)
    return counts


def _rank_work(rank, world):
    """Everything the module needs from the ranks, in one spawn."""
    import torch.distributed as dist
    import targetvae_tpu_torch.kernels.posterior as post
    from targetvae_tpu_torch.parallel.grid_softmax import sp_posterior_kernel

    group = dist.group.WORLD
    out = {}
    for name, (make, sig_r, loss) in SP_CASES.items():
        attn, noise, th, z, p, gx, gy, offs = make()
        c = attn.shape[1] // world
        cut = lambda v: torch.from_numpy(
            np.ascontiguousarray(v[..., rank * c:(rank + 1) * c]))
        leaves = [cut(v).requires_grad_() for v in (attn, th, z)]
        y = sp_posterior_kernel(group, sig_r, z.shape[2], leaves[0],
                                cut(noise), leaves[1], leaves[2],
                                *map(cut, (p, gx, gy, offs)))
        (torch.sin(y) if loss == "sin" else y).sum().div(world).backward()
        out[name] = [y.detach().numpy()] + [t.grad.numpy() for t in leaves]

    counts = _counting(post, ("posterior_shard_plain",
                              "posterior_shard_bwd_plain", "posterior_plain",
                              "posterior_bwd_plain"))
    trainer = Trainer(_model_config(), _sp_config(), device="cpu")
    state = trainer.init_state(0)
    generator, state.generator = state.generator, None
    state, m = trainer.train_step(state, _images())
    params = lambda: {n: p.detach().numpy().copy()
                      for n, p in trainer.model.named_parameters()}
    out["det_metrics"] = m.numpy()
    out["det_params"] = params()
    state.generator = generator
    out["sampled"] = np.stack([trainer.train_step(state, _images())[1].numpy()
                               for _ in range(SAMPLED_STEPS)])
    out["eval"] = trainer.eval_step(state, _images()).numpy()
    out["params"] = params()
    out["counts"] = dict(counts)

    # the float32 tier's SP step (posterior_block), deterministic, then
    # sampled from the initial generator's state
    f32 = {}
    for sampled in (False, True):
        trainer = Trainer(_model_config(), _sp_config(compute_dtype=None),
                          device="cpu")
        state = trainer.init_state(0)
        if not sampled:
            state.generator = None
        _, m = trainer.train_step(state, _images())
        f32[sampled] = {"metrics": m.numpy(), "grads": {
            n: p.grad.numpy().copy()
            for n, p in trainer.model.named_parameters()}}
    out["f32"] = f32

    # the host feed: a streamed epoch of the SP trainer with host_stream
    import hashlib
    import torch_port_ranks
    trainer = Trainer(_model_config(), _sp_config(host_stream=True,
                                                  minibatch_size=4),
                      device="cpu")
    state = trainer.init_state(1)
    means = torch_port_ranks.sp_stream_epoch(trainer, state, _images(10), 4)
    h = hashlib.sha256()
    for p in trainer.model.parameters():
        h.update(p.detach().numpy().tobytes())
    out["stream"] = {"means": means, "digest": h.hexdigest(),
                     "steps": state.step}
    return out


@pytest.fixture(scope="module")
def ranks():
    from targetvae_tpu_torch.parallel.distributed import run_local
    return run_local(_rank_work, T, backend="gloo", timeout=SPAWN_TIMEOUT)


# ---- K5/K6's plain versions against the Pallas kernels ----

def test_shard_partials_plain_match_jax_kernel():
    """One shard of a 4,096-cell grid (B=3, C=2,048, zd=2), the normalisers
    computed here over the whole grid: the forward and all five backward
    outputs. Both float32 with the same formulas, summed in other orders:
    rtol/atol 1e-5."""
    import jax.numpy as jnp
    from targetvae_tpu.kernels.posterior import (
        posterior_shard_partials as jax_partials)
    attn, noise, th, z, p, gx, gy, offs = _shard_inputs(3, 4096, 2, 3)

    def lse(x):
        m = x.max(axis=1, keepdims=True)
        return [m, np.log(np.exp(x - m).sum(axis=1, keepdims=True))]
    norms = np.concatenate(lse(attn) + lse(attn + noise), 1).astype(np.float32)
    cut = lambda v: np.ascontiguousarray(v[..., :2048])
    args = [norms] + [cut(v) for v in (attn, noise, th, z, p, gx, gy, offs)]
    g = np.random.default_rng(4).normal(size=(3, 9)).astype(np.float32)
    kw = {"sig_r": float(np.pi / 4), "zd": 2}
    ref_f = jax_partials(*map(jnp.asarray, args), interpret=True, **kw)
    ref_b = jax_partials(*map(jnp.asarray, args), interpret=True,
                         want_grads=True, g=jnp.asarray(g), **kw)
    targs = [torch.from_numpy(a) for a in args]
    got_f = posterior_shard_partials(*targs, **kw)
    got_b = posterior_shard_partials(*targs, want_grads=True,
                                     g=torch.from_numpy(g), **kw)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), rtol=1e-5,
                               atol=1e-5)
    assert len(got_b) == len(ref_b) == 5
    for a, b in zip(got_b, ref_b):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # the wrappers on CPU tensors are the plain versions
    torch.testing.assert_close(got_f, posterior_shard_plain(
        *targs, kw["sig_r"]), rtol=0, atol=0)
    for a, b in zip(got_b, posterior_shard_bwd_plain(
            *targs, kw["sig_r"], torch.from_numpy(g))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("zd", [8, 10])
def test_shard_partials_wide_latent_match_jax_kernel(zd):
    """K5/K6 take any z_dim (their templates reach 8, a run-time z_dim
    past it): the plain versions, through posterior_shard_partials, against
    the JAX kernel in interpret mode at z_dim 8 and 10, one shard of a
    2,048-cell grid (B=2, C=1,024); rtol/atol 1e-5, as at z_dim 2."""
    import jax.numpy as jnp
    from targetvae_tpu.kernels.posterior import (
        posterior_shard_partials as jax_partials)
    attn, noise, th, z, p, gx, gy, offs = _shard_inputs(2, 2048, zd, 5)

    def lse(x):
        m = x.max(axis=1, keepdims=True)
        return [m, np.log(np.exp(x - m).sum(axis=1, keepdims=True))]
    norms = np.concatenate(lse(attn) + lse(attn + noise), 1).astype(np.float32)
    cut = lambda v: np.ascontiguousarray(v[..., 1024:])
    args = [norms] + [cut(v) for v in (attn, noise, th, z, p, gx, gy, offs)]
    g = np.random.default_rng(6).normal(size=(2, 2 * zd + 5)).astype(
        np.float32)
    kw = {"sig_r": float(np.pi / 8), "zd": zd}
    ref_f = jax_partials(*map(jnp.asarray, args), interpret=True, **kw)
    ref_b = jax_partials(*map(jnp.asarray, args), interpret=True,
                         want_grads=True, g=jnp.asarray(g), **kw)
    targs = [torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(posterior_shard_partials(*targs, **kw).numpy(),
                               np.asarray(ref_f), rtol=1e-5, atol=1e-5)
    got_b = posterior_shard_partials(*targs, want_grads=True,
                                     g=torch.from_numpy(g), **kw)
    for a, b in zip(got_b, ref_b):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("cells, t, c", [(1156, 2, 1024), (100, 2, 1024),
                                         (2048, 2, 1024), (300, 3, 128)])
def test_heads_to_chunks_is_the_padded_exchange_buffer(cells, t, c):
    """The SP step's send buffer in one pass: the raw heads (b, cells, D)
    with log p(r) and the offsets added (bias (D, R)), padded to t * c
    cells with -1e30 logits and zero moments, cut into t chunks of c cells
    (b, D, c), equals the planes built step by step (transpose, add, cat
    the pads, chunk), exactly; and its backward returns the chunks'
    cotangent in the heads' layout, as autograd of that construction. A
    whole rank's chunk can be pads (100 cells)."""
    from targetvae_tpu_torch.parallel.grid_softmax import heads_to_chunks
    b, R, D = 3, 4, 7
    rng = np.random.default_rng(7)
    heads = torch.from_numpy(rng.normal(size=(b, cells, D)).astype(
        np.float32))
    bias = torch.zeros((D, R))
    bias[0], bias[1] = torch.tensor([-1.0, -2.0, -3.0, -4.0]), torch.tensor(
        [0.0, 1.5, 3.0, -1.5])
    h1, h2 = heads.clone().requires_grad_(), heads.clone().requires_grad_()
    got = heads_to_chunks(h1, bias, t, c)
    planes = h2.transpose(1, 2) + bias.repeat(1, cells // R)
    fill = torch.zeros((b, D, t * c - cells))
    fill[:, 0] = -1e30
    ref = torch.cat([planes, fill], dim=2).reshape(b, D, t, c).movedim(2, 0)
    assert got.shape == (t, b, D, c)
    assert torch.equal(got, ref)
    g = torch.from_numpy(rng.normal(size=(t, b, D, c)).astype(np.float32))
    got.backward(g)
    ref.backward(g)
    assert torch.equal(h1.grad, h2.grad)
    with pytest.raises(ValueError, match="rotations"):
        heads_to_chunks(heads, bias, 2, 1022)


# ---- the SP posterior over 2 ranks against JAX's under shard_map ----

def _jax_sp(case, monkeypatch):
    """JAX's sp_posterior_kernel on 2 virtual devices, interpret mode:
    (out, d attn, d th, d z) of the case's loss."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import targetvae_tpu.kernels.posterior as PK
    from targetvae_tpu.parallel import grid_softmax as GS
    from targetvae_tpu.parallel.mesh import make_mesh
    try:
        from jax import shard_map as sm
        kw = {"check_vma": False}
    except ImportError:
        from jax.experimental.shard_map import shard_map as sm
        kw = {"check_rep": False}
    orig = PK.posterior_shard_partials
    monkeypatch.setattr(PK, "posterior_shard_partials",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    make, sig_r, loss = SP_CASES[case]
    attn, noise, th, z, p, gx, gy, offs = map(jnp.asarray, make())
    zd = z.shape[2]
    mesh = make_mesh(jax.devices()[:T], data=1, model=T)

    def run(attn, th, z):
        f = sm(lambda *a: GS.sp_posterior_kernel("model", sig_r, zd, False,
                                                 *a),
               mesh=mesh,
               in_specs=(P(None, "model"), P(None, "model"),
                         P(None, None, "model"), P(None, None, None, "model"),
                         P("model"), P("model"), P("model"), P("model")),
               out_specs=P(), **kw)
        return f(attn, noise, th, z, p, gx, gy, offs)

    fl = (lambda *a: jnp.sum(jnp.sin(run(*a)))) if loss == "sin" else (
        lambda *a: jnp.sum(run(*a)))
    grads = jax.grad(fl, argnums=(0, 1, 2))(attn, th, z)
    return [np.asarray(run(attn, th, z))] + [np.asarray(g) for g in grads]


def _gather(ranks, case, i):
    """Output i of a case from every rank: the replicated forward from each
    rank, the gradients concatenated along the cells."""
    parts = [r[case][i] for r in ranks]
    return parts if i == 0 else np.concatenate(parts, axis=-1)


def test_sp_posterior_matches_jax_shard_map(ranks, monkeypatch):
    """B=3, C=4,096 over 2 ranks, same inputs and noise: the forward on
    every rank at rtol/atol 1e-5; the gradients of sum(sin(out)) at
    rtol 1e-4 / atol 1e-5, the bounds tests/test_grid_softmax.py holds the
    JAX kernel to against its unsharded reference."""
    ref = _jax_sp("random", monkeypatch)
    for out in _gather(ranks, "random", 0):
        np.testing.assert_allclose(out, ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["random"][0], ranks[1]["random"][0])
    for i in (1, 2, 3):
        got = _gather(ranks, "random", i)
        assert got.shape == ref[i].shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref[i], rtol=1e-4, atol=1e-5)


def test_sp_posterior_padding_is_dead(ranks, monkeypatch):
    """-1e30 padded cells (1,500 of 4,096 live; rank 1's shard all pads):
    finite outputs that match JAX's, finite gradients, and exactly zero
    gradient on the pads."""
    ref = _jax_sp("padded", monkeypatch)
    for out in _gather(ranks, "padded", 0):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref[0], rtol=1e-5, atol=1e-5)
    for i in (1, 2, 3):
        got = _gather(ranks, "padded", i)
        assert np.isfinite(got).all()
        assert np.abs(got[..., 1500:]).max() == 0.0
        np.testing.assert_allclose(got, ref[i], rtol=1e-4, atol=1e-5)


# ---- the SP Trainer over 2 ranks ----

def _single_step():
    """The single-process bf16 step from the same seed, no noise."""
    trainer = Trainer(_model_config(), TrainConfig(learning_rate=LR,
                                                   compute_dtype="bfloat16"),
                      device="cpu")
    state = trainer.init_state(0)
    state.generator = None
    state, m = trainer.train_step(state, _images())
    return m.numpy(), {n: p.detach().numpy()
                       for n, p in trainer.model.named_parameters()}


def test_sp_step_equals_single_process_step(ranks):
    """One deterministic SP step against the unsharded step on the same 4
    images and weights: the metrics at 1e-5 relative, and every parameter
    leaf after Adam at 1e-5 relative L2. The ranks differ from the single
    process only in sum order (the softmax normalised across two shards,
    the partials all-reduced, the encoder and decoder on 2 rows a rank).
    The exception is the attention head's bias, whose exact gradient is 0
    (the joint softmax ignores a shift of every logit): both sides hold
    rounding noise there, whose sign Adam's first step follows, so it is
    held to Adam's bound, no move beyond the learning rate."""
    m, params = _single_step()
    init = Trainer(_model_config(), TrainConfig(), device="cpu")
    init.init_state(0)
    before = {n: p.detach().numpy() for n, p in init.model.named_parameters()}
    for r in ranks:
        np.testing.assert_allclose(r["det_metrics"], m, rtol=1e-5)
        for name, ref in params.items():
            got = r["det_params"][name]
            if name == "encoder.conv_a.b":
                assert np.abs(got - before[name]).max() <= LR * (1 + 1e-3)
                continue
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= 1e-5, (name, rel)


@pytest.mark.parametrize("sampled", [False, True])
def test_f32_sp_step_equals_unsharded_step(ranks, sampled):
    """The float32 tier's SP step (TrainConfig(sp=True, tp=2), the plain
    posterior_block) on a single data row against the unsharded float32
    step from the same initial state: deterministic, and sampled from the
    same generator state (the Gumbel noise drawn once for the whole grid:
    the same sample). Metrics at 1e-5 relative; each gradient leaf at the
    SP bound, 1e-2 relative L2 (a rounding step in theta or dx flips the
    generator's leaky-ReLU slope at the odd pixel: tests/
    test_torch_port_sp_modes.py), the attention bias, exactly 0, below 1e-3
    of the attention weight's."""
    trainer = Trainer(_model_config(), TrainConfig(learning_rate=LR),
                      device="cpu")
    state = trainer.init_state(0)
    if not sampled:
        state.generator = None
    _, m = trainer.train_step(state, _images())
    grads = {n: p.grad.numpy() for n, p in trainer.model.named_parameters()}
    floor = 1e-3 * np.linalg.norm(grads["encoder.conv_a.w"])
    for r in ranks:
        got = r["f32"][sampled]
        np.testing.assert_allclose(got["metrics"], m.numpy(), rtol=1e-5)
        for name, g in grads.items():
            rel = (np.linalg.norm(got["grads"][name]) / floor
                   if name == "encoder.conv_a.b" else
                   np.linalg.norm(got["grads"][name] - g) / np.linalg.norm(g))
            assert rel <= (1.0 if name == "encoder.conv_a.b" else 1e-2), (
                name, rel)


def test_sp_ranks_stay_bitwise_identical(ranks):
    """Every rank takes the same Adam step on all-reduced gradients: after
    one deterministic and three sampled steps the parameters are bitwise
    equal across ranks, as are the all-reduced metrics."""
    a, b = ranks
    assert a["params"].keys() == b["params"].keys()
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name])
    np.testing.assert_array_equal(a["sampled"], b["sampled"])
    np.testing.assert_array_equal(a["eval"], b["eval"])


def test_sp_sampled_steps_are_finite_and_move(ranks):
    """Three sampled steps: finite [elbo, log_p, kl] with elbo = log_p - kl,
    not all equal (the noise differs per step), and a finite eval step."""
    s = ranks[0]["sampled"]
    assert s.shape == (SAMPLED_STEPS, 3) and np.isfinite(s).all()
    np.testing.assert_allclose(s[:, 0], s[:, 1] - s[:, 2], rtol=1e-5,
                               atol=1e-4)
    assert len(set(s[:, 0].tolist())) == SAMPLED_STEPS
    assert np.isfinite(ranks[0]["eval"]).all()


def test_sp_step_runs_the_shard_kernels_only(ranks):
    """On the CPU the SP step runs K5/K6's plain versions (forward: one a
    step and one for eval; backward: one a step) and never K3/K4's."""
    steps = 1 + SAMPLED_STEPS
    for r in ranks:
        c = r["counts"]
        assert c["posterior_shard_plain"] == steps + 1, c
        assert c["posterior_shard_bwd_plain"] == steps, c
        assert c["posterior_plain"] == 0 and c["posterior_bwd_plain"] == 0, c


# ---- configuration ----

@pytest.mark.parametrize("kw, error, match", [
    ({"sp": True, "tp": 1, "compute_dtype": "bfloat16"}, ValueError, "tp > 1"),
    ({"sp": True, "tp": 2}, RuntimeError, "process group"),
    ({"tp": 2, "compute_dtype": "bfloat16"}, RuntimeError, "process group"),
    ({"sp": True, "tp": 2, "compute_dtype": "bfloat16"}, RuntimeError,
     "process group"),
])
def test_sp_config_validation(kw, error, match):
    """sp needs tp > 1 and a process group of dp * tp ranks (none is
    initialised in this process), on either tier; so does tp > 1 without
    sp (tensor parallelism). sp with dp > 1 and with the host feed run:
    test_sp_config_runs."""
    with pytest.raises(error, match=match):
        Trainer(_model_config(), TrainConfig(**kw), device="cpu")


def _dp_sp_stream_work(rank, world):
    """Trainer(sp=True, tp=2, dp=2, host_stream=True) on 4 ranks: a
    host-streamed epoch of 10 images at B = 4 (each rank gathers its data
    row's 2 rows of every batch, the tail wrapped around with zero
    weights), sampled: the epoch's means and a digest of the parameters."""
    import hashlib
    import torch_port_ranks
    trainer = Trainer(_model_config(), _sp_config(dp=2, host_stream=True,
                                                  minibatch_size=4),
                      device="cpu")
    state = trainer.init_state(0)
    means = torch_port_ranks.sp_stream_epoch(trainer, state, _images(10), 4)
    h = hashlib.sha256()
    for p in trainer.model.parameters():
        h.update(p.detach().numpy().tobytes())
    return {"means": means, "digest": h.hexdigest(), "steps": state.step,
            "mesh": (trainer.mesh.data, trainer.mesh.model)}


@pytest.fixture(scope="module")
def dp_sp_stream():
    from targetvae_tpu_torch.parallel.distributed import run_local
    return run_local(_dp_sp_stream_work, 4, backend="gloo",
                     timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("case", ["dp", "host_stream"])
def test_sp_config_runs(case, ranks, dp_sp_stream):
    """What test_sp_config_validation refused before the data axis and
    the host feed were ported now runs. dp: sp with tp = 2 and dp = 2 on 4
    ranks, a (2, 2) mesh, takes a streamed epoch of 3 sampled steps,
    finite, the ranks bitwise equal. host_stream: the 2-rank SP trainer
    with host_stream=True takes a streamed epoch (each rank gathers its
    rows), finite, the ranks agreeing."""
    if case == "dp":
        runs = dp_sp_stream
        assert all(r["mesh"] == (2, 2) for r in runs)
    else:
        runs = [r["stream"] for r in ranks]
    assert all(r["steps"] == runs[0]["steps"] for r in runs)
    assert runs[0]["steps"] > 1
    assert len({r["digest"] for r in runs}) == 1
    assert len({r["means"] for r in runs}) == 1
    assert np.isfinite(runs[0]["means"]).all()
