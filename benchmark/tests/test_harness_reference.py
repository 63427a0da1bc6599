"""The plain reference (benchmark/reference/) against the port's float32
tier at a tiny size: the ELBO and its parts, every leaf's gradient, the
embedding; the CTF kernels against the port's ctf_filter; the sampling
noise against the port's draws, and the sampled steps followed. And the
control's rounding."""

import json

import numpy as np
import pytest
import torch

from benchmark import drive, generate, judge, spec
from benchmark.reference import model as ref
from benchmark.reference import noise
from benchmark.reference.ctf import correlate_same, ctf_kernels
from benchmark.tests.conftest import make_root, tiny_config

SEED = 2 ** 31 + 99


def _setup(source):
    from targetvae_tpu_torch.models.targetvae import TargetVAE
    from targetvae_tpu_torch.utils.config import ModelConfig
    cfg = tiny_config(source)
    y, micro, table = generate.images(cfg, 6, SEED, "cpu")
    ctf = None
    if table is not None:
        ctf = ctf_kernels(table, cfg["ctf_dim"], "cpu")[micro]
    params = generate.weights(cfg["model"], SEED, "cpu")
    port = TargetVAE(ModelConfig.from_json(json.dumps(cfg["model"])), "cpu")
    port.load_params(generate.clone(params))
    return cfg, y, ctf, params, port


@pytest.mark.parametrize("source", ["mnist-u-p8", "empiar-10025"])
def test_elbo_and_gradients_equal_the_ports_float32_tier(source):
    cfg, y, ctf, params, port = _setup(source)
    mine = judge.to_device(params, "cpu")
    named = judge.leaves(mine)
    for t in named.values():
        t.requires_grad_(True)
    got = ref.elbo(mine, cfg["model"], y, ctf)
    g_ref = torch.autograd.grad(-got[0], list(named.values()))
    want = port.elbo(port.params(), port.base_grid(), y, None, None, ctf)
    (-want[0]).backward()
    for a, b in zip(got, want):
        assert float(a.detach()) == pytest.approx(float(b.detach()),
                                                  rel=1e-5, abs=1e-4)
    grads = {k.replace("spatial_generator.", "generator.", 1): p.grad
             for k, p in port.named_parameters()}
    # to 1e-5 of the largest gradient: the attention logit's bias, under a
    # softmax, has a gradient that is round-off alone
    top = max(float(g.abs().max()) for g in g_ref)
    for k, gp in zip(named, g_ref):
        assert torch.allclose(gp, grads[k], rtol=1e-4, atol=1e-5 * top), k


@pytest.mark.parametrize("source", ["mnist-u-p8", "empiar-10025"])
def test_embed_equals_the_ports(source):
    cfg, y, _, params, port = _setup(source)
    z, th, dx, _ = ref.embed(params, cfg["model"]["encoder"], y)
    with torch.no_grad():
        want = port.embed(port.params(), y, None)
    assert torch.allclose(z, want["z_content"], atol=1e-5, rtol=1e-5)
    assert torch.allclose(th, want["theta_mu"], atol=1e-5)
    assert torch.allclose(dx, want["dx"], atol=1e-6)


@pytest.mark.parametrize("seed", [5, 2 ** 31 - 2])
def test_gumbel_noise_is_the_ports_bit_for_bit(seed):
    """The card's Philox draws (computed here on the host) and the host
    tier's per-image generators, against the port's own functions."""
    from targetvae_tpu_torch.kernels import posterior
    gumbel = lambda u: -torch.log(-torch.log(u.clamp(1e-20, 1 - 1e-7)))
    assert torch.equal(gumbel(noise.philox_uniform(seed, 3, 4, 25, "cpu")),
                       posterior.philox_gumbel(seed, 3, 4, 25, "cpu"))
    assert torch.equal(gumbel(noise.host_uniform(seed, 3, 4, 25)),
                       posterior.per_image_gumbel(seed, (3, 4, 25), "cpu"))
    # the reference's cell order: position-major, rotation-minor
    g = noise.gumbel(seed, 3, 4, 25, "cpu").reshape(3, 25, 4)
    assert torch.equal(g.transpose(1, 2), gumbel(noise.host_uniform(
        seed, 3, 4, 25)))


@pytest.mark.parametrize("source", ["mnist-u-p8", "empiar-10025"])
def test_the_reference_follows_the_sampled_steps(tmp_path, source):
    """The checked steps sample as the window does; the reference that
    draws the run's noise follows them, and one that draws another seed's
    noise, or none, reads ten times farther."""
    cell = spec.load_cell("tiny.train", make_root(tmp_path, source))
    d = drive.prepare(cell, SEED, torch.device("cpu"))
    prog = d.check_steps()
    inputs = d.release()
    read = lambda **kw: judge.train_numbers(
        prog, judge.reference_steps(**{**inputs, **kw}))
    right = read()
    for other in (read(noise_seed=inputs["noise_seed"] + 1),
                  read(noise_seed=None)):
        assert other["loss_gap"] > 10 * right["loss_gap"], (right, other)


def test_ctf_kernels_equal_the_ports_ctf_filter():
    from targetvae_tpu_torch.data.ctf import ctf_filter
    table = {"defocus": np.array([1.0, 1.7, 2.5]), "cs": np.full(3, 2.0),
             "voltage": np.full(3, 300.0), "apix": np.full(3, 1.5),
             "bfactor": np.zeros(3), "ampcont": np.full(3, 7.0),
             "dfdiff": np.zeros(3), "dfang": np.zeros(3)}
    mine = ctf_kernels(table, 109, "cpu").numpy()
    port = ctf_filter(table, 109, 109)
    assert np.allclose(mine, port, atol=1e-6 * np.abs(port).max())


def test_correlation_is_the_fft_one():
    g = torch.Generator().manual_seed(0)
    img = torch.randn((3, 20, 20), generator=g)
    ker = torch.randn((3, 9, 9), generator=g)
    assert torch.allclose(correlate_same(img, ker),
                          generate.correlate_fft(img, ker), atol=1e-4)


def test_fp8_rounds_coarser_than_bf16_both_ways():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    w = torch.linspace(1, 2, 1001)[:, None]
    y = judge.FP8.mm(x[None], w)
    y.backward(torch.full_like(y, 0.7))
    exact = x.detach()[None] @ w
    e8 = float((y.detach() - exact).abs().max() / exact.abs().max())
    assert 1e-4 < e8 < 0.07
    e16 = (x.detach().bfloat16().float() - x.detach()).abs().max() / 3
    assert 8 * e16 < (judge._e4m3(x.detach()) - x.detach()).abs().max() / 3
    # the gradient went through e5m2 and e4m3 operands: 0.7 (w_q)
    assert not torch.allclose(x.grad, 0.7 * w[:, 0], rtol=1e-6)
