"""The frozen yardstick (benchmark/counts/flops.py) against the port's
targetvae_tpu_torch/utils/flops.py as it stands, term by term, on both
configurations."""

import json

import pytest

from benchmark import drive
from benchmark.counts import flops as frozen
from benchmark.tests.conftest import ROOT


def _configs():
    from targetvae_tpu_torch.utils.config import ModelConfig
    out = []
    for name in ("mnist-u-p8", "empiar-10025"):
        cfg = json.loads((ROOT / "benchmark/configs" / f"{name}.json")
                         .read_text())
        out.append((name, ModelConfig.from_json(json.dumps(cfg["model"])),
                    drive.model_namespace(cfg["model"]), cfg.get("ctf_dim")))
    return out


@pytest.mark.parametrize("batch", [100, 50, 7])
@pytest.mark.parametrize("i", [0, 1])
def test_counts_equal_the_ports(i, batch):
    from targetvae_tpu_torch.utils import flops as port
    _, cfg, ns, ctf = _configs()[i]
    for c in (cfg, ns):
        assert frozen.step_flops(c, batch, ctf) == port.step_flops(
            cfg, batch, ctf)
        assert frozen.encoder_flops(c, batch) == port.encoder_flops(
            cfg, batch)
        assert frozen.decoder_flops(c, batch) == port.decoder_flops(
            cfg, batch)
        assert frozen.kernel_products(c, batch) == port.kernel_products(
            cfg, batch)
        assert frozen.kernel_bounds(c, batch, 2048) == port.kernel_bounds(
            cfg, batch, 2048)
    assert frozen.ctf_fft(cfg, batch, 109) == port.ctf_fft(cfg, batch, 109)


def test_peaks_and_forward_count():
    from targetvae_tpu_torch.utils import flops as port
    assert (frozen.PEAK_BF16, frozen.PEAK_TF32, frozen.PEAK_F32,
            frozen.HBM_BPS) == (port.PEAK_BF16, port.PEAK_TF32,
                                port.PEAK_F32, port.HBM_BPS)
    assert frozen.PEAK_BF16 == port.tier_peak("bfloat16") == 989e12
    for _, cfg, ns, _ in _configs():
        # the forward of the lift, the mixing and the heads: a third of
        # the mixing's and the heads' train count, half the lift's
        enc = port.encoder_flops(cfg, 100)
        want = enc["lift_conv"] / 2 + (enc["mixing"] + enc["heads"]) / 3
        assert frozen.encoder_forward_flops(ns, 100) == pytest.approx(
            want, rel=1e-12)
