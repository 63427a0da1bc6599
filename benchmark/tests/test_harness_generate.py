"""The generator: the same seed gives the same inputs, weights and
requests; another seed other values but the same amount of work."""

import json

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.tests.conftest import ROOT, tiny_config

SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("source", ["mnist-u-p8", "empiar-10025"])
def test_images_repeat_for_a_seed(source):
    cfg = tiny_config(source)
    a = generate.images(cfg, 30, SEED, "cpu")
    b = generate.images(cfg, 30, SEED, "cpu")
    c = generate.images(cfg, 30, SEED + 1, "cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    d = cfg["model"]["encoder"]["image_dim"]
    assert a[0].shape == (30, d, d, 1) and torch.isfinite(a[0]).all()
    if cfg["data"]["kind"] == "shapes":
        assert a[0].min() >= 0 and a[0].max() <= 1
        assert torch.equal(a[0] * 255, (a[0] * 255).round())
    else:
        assert torch.equal(a[1], b[1])
        for k in a[2]:
            assert torch.equal(a[2][k], b[2][k])
        std = a[0].reshape(30, -1).std(1, correction=0)
        assert torch.allclose(std, torch.ones(30), atol=1e-4)


@pytest.mark.parametrize("source", ["mnist-u-p8", "empiar-10025"])
def test_weights_repeat_and_take_the_ports_layout(source):
    from targetvae_tpu_torch.models.targetvae import TargetVAE
    from targetvae_tpu_torch.utils.config import ModelConfig
    model = json.loads((ROOT / "benchmark/configs" / f"{source}.json")
                       .read_text())["model"]
    a = generate.weights(model, SEED, "cpu")
    b = generate.weights(model, SEED, "cpu")
    c = generate.weights(model, SEED + 1, "cpu")
    flat = lambda t: torch.cat([v.reshape(-1) for v in _leaves(t)])
    assert torch.equal(flat(a), flat(b)) and not torch.equal(flat(a), flat(c))
    port = TargetVAE(ModelConfig.from_json(json.dumps(model)), "cpu")
    ref = port.init(torch.Generator().manual_seed(0))
    assert _shapes(ref) == _shapes(a)
    port.load_params(generate.clone(a))
    # the reference's init bounds: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    k = model["encoder"]["kernels_size"]
    assert a["encoder"]["conv1"]["w"].abs().max() <= 1 / k
    assert a["generator"]["hidden"][0]["w"].abs().max() <= 512 ** -0.5


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shapes(v) for v in t]
    return tuple(t.shape)


def test_embed_requests_are_the_configurations_whole_stack():
    mix = json.loads((ROOT / "benchmark/traffic/embed-stack.json")
                     .read_text())
    sizes = {}
    for name in ("mnist-u-p8", "empiar-10025"):
        cfg = json.loads((ROOT / "benchmark/configs" / f"{name}.json")
                         .read_text())
        sizes[name] = cfg[mix["stack"]]
    # the MNIST-U test set; the particle stack the train cell holds
    assert sizes == {"mnist-u-p8": 10000, "empiar-10025": 4050}


def test_shapes_match_the_stamps_of_the_synthetic_tool():
    stamps = generate.shape_stamps()
    assert stamps.shape == (7, 28, 28)
    assert set(np.unique(stamps)) == {0.0, 255.0}
