"""The port's FLOP accounting and roofline (targetvae_tpu_torch/utils/
flops.py) against the JAX package's (targetvae_tpu/utils/flops.py), against
torch.utils.flop_counter.FlopCounterMode over the port's own train step and
kernels' plain versions on the CPU, and against PERF.md's bound tables.

FlopCounterMode counts the matrix products and convolutions PyTorch
dispatches (mm, bmm, convolution and their backward), not FFTs. The JAX
package's convention leaves some of the port's products uncounted; each is
named (uncounted_float32, uncounted_bf16) and added, so that the count and
the analytic total agree to float rounding.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from targetvae_tpu.utils import flops as jax_flops
from targetvae_tpu.utils.config import ModelConfig as JaxModelConfig
from targetvae_tpu_torch.losses.likelihoods import ctf_apply
from targetvae_tpu_torch.models.encoders import attn_dim_for
from targetvae_tpu_torch.train import Trainer
from targetvae_tpu_torch.utils import flops
from targetvae_tpu_torch.utils.config import (EncoderConfig, GeneratorConfig,
                                              LikelihoodConfig, ModelConfig,
                                              TrainConfig)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "bench_config_torch", os.path.join(REPO, "tools",
                                           "bench_config_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


# ---- against the JAX package's count, at full width ----

@pytest.mark.parametrize("name", TOOL.CONFIGS)
def test_step_flops_equals_jax_term_by_term(name):
    """encoder_flops and decoder_flops equal the JAX package's term by term
    on each of tools/bench_config.py's configs (the same JSON builds both
    packages' configs), at the default batch and at 100; the CTF term is
    the port's FFT count where JAX's is its DFT matmuls."""
    cfg, n, _, with_ctf = TOOL.build(name)
    jcfg = JaxModelConfig.from_json(cfg.to_json())
    for batch in (TOOL.DEFAULT_BATCH[name], 100):
        assert flops.encoder_flops(cfg, batch) == jax_flops.encoder_flops(
            jcfg, batch)
        assert flops.decoder_flops(cfg, batch) == jax_flops.decoder_flops(
            jcfg, batch)
        ctf_dim = n - 1 if with_ctf else None
        got = flops.step_flops(cfg, batch, ctf_dim)["breakdown"]
        ref = jax_flops.step_flops(jcfg, batch, ctf_dim)["breakdown"]
        assert ("ctf_fft" in got) == ("ctf_dft" in ref) == with_ctf
        got.pop("ctf_fft", None)
        ref.pop("ctf_dft", None)
        assert got == ref


@pytest.mark.parametrize("fit_noise", [False, True])
def test_ctf_fft_is_five_real_ffts_an_image(fit_noise):
    """ctf_fft: five real 2-D FFTs of S^2 points an image, 2.5 N log2 N each,
    S = n + kc - 1 (218 at EMPIAR: ~0.9 GFLOP a step of 100), doubled with
    fit_noise."""
    cfg, n, _, _ = TOOL.build("particles-ctf")
    cfg = dataclasses.replace(cfg, likelihood=dataclasses.replace(
        cfg.likelihood, fit_noise=fit_noise))
    S = n + (n - 1) - 1
    expect = 5 * 2.5 * S * S * math.log2(S * S) * 100 * (2 if fit_noise else 1)
    got = flops.ctf_fft(cfg, 100, n - 1)["ctf_fft"]
    assert got == pytest.approx(expect, rel=1e-12)
    assert 0.9e9 < flops.ctf_fft(TOOL.build("particles-ctf")[0], 100,
                                 n - 1)["ctf_fft"] < 0.95e9


class _FFTs(TorchDispatchMode):
    """Records each FFT op PyTorch dispatches: (kind, its input's shape)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "_fft_" in str(func):
            self.calls.append((str(func).split("_fft_")[1].split(".")[0],
                               tuple(args[0].shape)))
        return func(*args, **(kwargs or {}))


def test_ctf_apply_runs_the_ffts_ctf_fft_counts():
    """losses/likelihoods.py::ctf_apply, forward and backward (the kernels
    take no gradient): three transforms forward (rfft2 of y and of the
    flipped kernel, irfft2) and two backward, all at S x S. The second
    backward one (rfft2's transpose) PyTorch runs as a full complex
    transform (c2c), which ctf_fft counts at a real one's 2.5 N log2 N."""
    n, kc = 14, 13
    S = n + kc - 1
    y = torch.randn(3, n, n, requires_grad=True)
    with _FFTs() as spy:
        out = ctf_apply(y, torch.randn(3, kc, kc))
        fwd = list(spy.calls)
        out.square().sum().backward()
    bwd = spy.calls[len(fwd):]
    assert sorted(k for k, _ in fwd) == ["c2r", "r2c", "r2c"]
    assert sorted(k for k, _ in bwd) == ["c2c", "r2c"]
    for kind, shape in fwd + bwd:
        assert shape[-2] == S and shape[-1] in (S, S // 2 + 1), (kind, shape)


# ---- against FlopCounterMode over the port's train step (CPU) ----

def _small(mode: str, groupconv: int = 8, c: int = 1, gaussian=False,
           fit_noise=False) -> ModelConfig:
    n = 14
    gen = GeneratorConfig(z_dim=2, hidden_dim=64,
                          n_out=2 if fit_noise else c, num_layers=2,
                          fourier_expansion=True, fourier_sigma=2 / (n - 1),
                          embedding_dim=64)
    if mode == "A":
        enc = EncoderConfig(t_inf="unimodal", r_inf="unimodal", image_dim=n,
                            in_channels=c, kernels_num=16, num_layers=2)
    elif mode == "B":
        enc = EncoderConfig(t_inf="attention", r_inf="unimodal", image_dim=n,
                            in_channels=c, kernels_num=16,
                            groupconv=groupconv)
    else:
        enc = EncoderConfig(image_dim=n, in_channels=c, kernels_num=16,
                            kernels_size=8, padding=3, groupconv=groupconv)
    lik = (LikelihoodConfig(kind="gaussian", mask_radius=5,
                            fit_noise=fit_noise) if gaussian
           else LikelihoodConfig(kind="bernoulli"))
    return ModelConfig(gen, enc, lik)


CASES = {"mode A": (_small("A"), False),
         "mode B groupconv 0": (_small("B", 0), False),
         "mode B groupconv 8": (_small("B", 8), False),
         "mode C P8": (_small("C"), False),
         "mode C C=3": (_small("C", c=3), False),
         "particles CTF": (_small("C", gaussian=True), True),
         "particles CTF fit-noise": (_small("C", gaussian=True,
                                            fit_noise=True), True)}
B = 4
KC = 13


def _counted(cfg, dtype=None, ctf=False, tier="conv", monkeypatch=None):
    """FlopCounterMode's count of one train step (after one not counted) of
    cfg at batch B on the CPU."""
    if monkeypatch is not None:
        monkeypatch.setenv("TARGETVAE_ENCODER_TIER", tier)
    tr = Trainer(cfg, TrainConfig(compute_dtype=dtype), device="cpu")
    st = tr.init_state(0)
    e = cfg.encoder
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.random((B, e.image_dim, e.image_dim,
                                     e.in_channels), np.float32))
    kern = (torch.from_numpy(rng.normal(size=(B, KC, KC)).astype(np.float32)
                             * 0.05) if ctf else None)
    tr.train_step(st, y, ctf=kern)
    with FlopCounterMode(display=False) as fc:
        tr.train_step(st, y, ctf=kern)
    return fc.get_total_flops()


def _matmul_total(cfg, ctf: bool) -> float:
    """step_flops without its FFT term, which FlopCounterMode does not see."""
    sf = flops.step_flops(cfg, B, KC if ctf else None)
    return sf["total"] - sf["breakdown"].get("ctf_fft", 0.0)


def _rotation(cfg) -> int:
    """The lift's filter bank rotated by bilinear interpolation as a
    4-tap product (R k^2 C, K, 4) x (4, 1), and its weight gradient: the
    JAX package builds the rotations as a static gather."""
    e = cfg.encoder
    if e.mode == "A" or e.groupconv == 0:
        return 0
    k = e.kernels_size if e.mode == "C" else e.image_dim
    return 2 * (2 * e.groupconv * k * k * e.in_channels * e.kernels_num * 4)


def _cells(cfg) -> tuple:
    e = cfg.encoder
    hw = attn_dim_for(e) ** 2
    return hw, hw * (e.groupconv if e.mode == "C" else 1)


def uncounted_float32(cfg) -> int:
    """The float32 tier's products that step_flops leaves out, by name."""
    e, g = cfg.encoder, cfg.generator
    px = B * e.image_dim ** 2
    # the coordinates' projection onto the F frequencies, a contraction over
    # 2, and its input gradient (the pose's; the frequencies are fixed)
    out = 2 * (2 * px * 2 * g.embedding_dim)
    out += _rotation(cfg)
    if e.mode == "A":
        return out
    hw, cells = _cells(cfg)
    # the posterior's moments (E[dx], E[theta], E[z] over the cells) as
    # products, forward 8 B cells + 4 B H'W', backward twice that
    out += 24 * B * cells + 8 * B * hw
    if e.mode == "B" and e.groupconv:
        # fc_r as its own product ((R) x 1 a channel), then a K x K mixing,
        # where step_flops counts the kernel tier's fold ((R K) x K)
        pos, K, R = B * hw, e.kernels_num, e.groupconv
        out += 3 * (2 * pos * K * R) + 3 * (2 * pos * K * K) \
            - 3 * (2 * pos * R * K * K)
    return out


@pytest.mark.parametrize("case", CASES)
def test_flop_counter_matches_step_flops_float32(case):
    """FlopCounterMode over the port's float32 train step equals
    step_flops's matrix-product total plus the named uncounted products, to
    float rounding (1e-12 relative): the accounting misses no product of
    the step. Without them the count runs 0.94-1.01 of step_flops at these
    widths (mode B at groupconv 8 below it: the float32 tier applies fc_r
    before the mixing)."""
    cfg, ctf = CASES[case]
    got = _counted(cfg, ctf=ctf)
    want = _matmul_total(cfg, ctf) + uncounted_float32(cfg)
    assert got == pytest.approx(want, rel=1e-12, abs=0)


def uncounted_bf16(cfg, tier: str) -> int:
    """On the CPU the bf16 tier's kernels run their plain versions, which
    FlopCounterMode counts: each kernel's products (flops.kernel_products),
    of which the recomputed ones are not in step_flops; and K3's plain
    version forms the moments as products (8 B cells + 4 B H'W'), which
    the kernel does as elementwise sums. With the filter bank's rotation,
    the rest of the step (the cuDNN lift, latent_linear) is step_flops's."""
    e = cfg.encoder
    products = flops.kernel_products(cfg, B)
    out = _rotation(cfg)
    if e.mode == "A":
        return out
    enc = ("mix_heads_r1" if e.mode == "B"
           else "lifted_encoder" if tier == "patch" else "mix_heads")
    out += products[enc + "_bwd"][1]
    hw, cells = _cells(cfg)
    return out + 8 * B * cells + 4 * B * hw


@pytest.mark.parametrize("case,tier", [
    ("mode A", "conv"), ("mode B groupconv 8", "conv"), ("mode C P8", "conv"),
    ("mode C P8", "patch"), ("particles CTF", "conv")])
def test_flop_counter_matches_step_flops_bf16(case, tier, monkeypatch):
    """The count chip_smoke's phase 21 makes on the card (FlopCounterMode
    plus each launched kernel's products less its recomputed ones, against
    step_flops), held on the CPU, where the kernels' plain versions are
    counted in place of the kernels: to float rounding once the named
    products are added."""
    cfg, ctf = CASES[case]
    got = _counted(cfg, "bfloat16", ctf, tier, monkeypatch)
    want = _matmul_total(cfg, ctf) + uncounted_bf16(cfg, tier)
    assert got == pytest.approx(want, rel=1e-12, abs=0)


# ---- each kernel's products against its plain version ----

def _kernel_cases():
    """(kernel, plain function, its arguments, config, batch) at small
    widths: mode C P4 (K = 16, D = 7, H' = 13), its Fourier decoder (F =
    64, hidden 32, 3 layers, n_out 2), mode B at groupconv 4."""
    from targetvae_tpu_torch.kernels import decoder_mlp as dm
    from targetvae_tpu_torch.kernels import decoder_pose as dp
    from targetvae_tpu_torch.kernels import lift_conv as lc
    from targetvae_tpu_torch.kernels import lifted_encoder as le
    from targetvae_tpu_torch.kernels import mix_heads as mh
    b, n, R, K, D, F, H, L, n_out = 2, 14, 4, 16, 7, 64, 32, 3, 2
    gen = GeneratorConfig(z_dim=2, hidden_dim=H, n_out=n_out, num_layers=L,
                          fourier_expansion=True, embedding_dim=F)
    cfg_c = ModelConfig(gen, EncoderConfig(
        image_dim=n, kernels_num=K, kernels_size=8, padding=3, groupconv=R))
    cfg_b = ModelConfig(gen, EncoderConfig(
        t_inf="attention", r_inf="unimodal", image_dim=n, kernels_num=K,
        groupconv=R))
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g)
    N = b * attn_dim_for(cfg_c.encoder) ** 2
    ck = 64
    mix = (rn(K, K), rn(K), rn(K, D), rn(D))        # w2, b2, wh, bh
    k1 = (rn(N, R * K).bfloat16(), rn(R * K)) + mix
    k2 = k1[:5] + (rn(N, R * D),)
    k11 = (rn(N, ck).bfloat16(), rn(ck, R * K), rn(R * K)) + mix
    k12 = (k11[0], rn(N, R * K).bfloat16()) + mix[:3] + (rn(N, R * D),)
    Nb = b * attn_dim_for(cfg_b.encoder) ** 2
    r1 = (rn(Nb, R * K).bfloat16(), rn(R * K), rn(R * K, K), rn(K),
          rn(K, D), rn(D))
    r1b = r1[:5] + (rn(Nb, D),)
    dec = (rn(b, H), rn(F, H), rn(H), rn(L - 1, H, H), rn(L - 1, H),
           rn(H, n_out), rn(n_out))
    tables = tuple(rn(b, n, F) for _ in range(4))
    hs = rn(L, b, n * n, H).bfloat16()
    x = rn(b, n * n, 2)
    wf, bf = rn(2, F), rn(F)
    gy = rn(b, n * n, n_out)
    y = rn(b, n, n, 1)
    lc_c = (rn(R * K, 1, 8, 8).bfloat16(), 3)            # w, padding
    lc_b = (rn(R * K, 1, n, n).bfloat16(), n // 2)
    return [
        ("lift_conv_fwd", lambda: lc.lift_conv_plain(y, *lc_c), cfg_c, b),
        ("lift_conv_fwd[mode B]", lambda: lc.lift_conv_plain(y, *lc_b),
         cfg_b, b),
        ("mix_heads_fwd", lambda: mh.lift_act_mix_heads_plain(*k1, R=R, K=K),
         cfg_c, b),
        ("mix_heads_bwd",
         lambda: mh.lift_act_mix_heads_bwd_plain(*k2, R=R, K=K), cfg_c, b),
        ("lifted_encoder_fwd",
         lambda: le.lifted_encoder_plain(*k11, R=R, K=K), cfg_c, b),
        ("lifted_encoder_bwd",
         lambda: le.lifted_encoder_bwd_plain(*k12, R=R, K=K), cfg_c, b),
        ("pose_decoder_fwd", lambda: dp.pose_decoder_plain(*tables, *dec),
         cfg_c, b),
        ("pose_decoder_bwd",
         lambda: dp.pose_decoder_bwd_plain(*tables, hs, dec[1], dec[3],
                                           dec[5], gy), cfg_c, b),
        ("decoder_mlp_fwd", lambda: dm.decoder_mlp_plain(x, wf, bf, *dec),
         cfg_c, b),
        ("decoder_mlp_bwd",
         lambda: dm.decoder_mlp_bwd_plain(x, wf, bf, *dec, gy), cfg_c, b),
        ("mix_heads_r1_fwd",
         lambda: mh.lift_act_mix_heads_plain(*r1, R=1, K=K), cfg_b, b),
        ("mix_heads_r1_bwd",
         lambda: mh.lift_act_mix_heads_bwd_plain(*r1b, R=1, K=K), cfg_b, b),
    ]


KERNEL_CASES = {c[0]: c for c in _kernel_cases()}


@pytest.mark.parametrize("kernel", KERNEL_CASES)
def test_kernel_products_equal_flop_counter_of_plain_version(kernel):
    """Each matrix-product kernel's roofline operations (kernel_products,
    which kernel_bounds and r1_bounds divide by the bf16 peak) are exactly
    what FlopCounterMode counts in its plain version, which repeats the
    kernel's arithmetic: K1, K2, K7, K8, K9, K10, K11, K12, K13 (modes C
    and B), and K1 / K2 at R = 1."""
    _, fn, cfg, b = KERNEL_CASES[kernel]
    with FlopCounterMode(display=False) as fc:
        fn()
    want = (flops.lift_conv_products(cfg, b) if kernel.startswith("lift_conv")
            else flops.kernel_products(cfg, b)[kernel][0])
    assert fc.get_total_flops() == want


# ---- the roofline, as PERF.md section 6 prints it ----

FLAGSHIP_BOUNDS = {    # B = 100, K5/K6 at the two-rank shard of 6,144 cells
    "mix_heads_fwd": ("0.103", "bytes"), "mix_heads_bwd": ("0.196", "bytes"),
    "posterior_fwd": ("0.010", "bytes"), "posterior_bwd": ("0.020", "bytes"),
    "posterior_shard_fwd": ("0.0059", "bytes"),
    "posterior_shard_bwd": ("0.0118", "bytes"),
    "pose_decoder_fwd": ("0.398", "operations"),
    "pose_decoder_bwd": ("0.796", "operations"),
    "decoder_mlp_fwd": ("0.398", "operations"),
    "decoder_mlp_bwd": ("1.194", "operations"),
    "lifted_encoder_fwd": ("0.289", "operations"),
    "lifted_encoder_bwd": ("0.372", "operations")}
EMPIAR_BOUNDS = {      # B = 100, n_out 1 (n_out 2: the fit-noise generator)
    "mix_heads_fwd": ("0.423", "bytes"), "mix_heads_bwd": ("0.805", "bytes"),
    "posterior_fwd": ("0.0417", "bytes"), "posterior_bwd": ("0.0835", "bytes"),
    "pose_decoder_fwd": ("1.926", "operations"),
    "pose_decoder_bwd": ("3.851", "operations"),
    "lifted_encoder_fwd": ("5.468", "operations"),
    "lifted_encoder_bwd": ("5.808", "operations")}


def _printed(ms: float, digits: str) -> str:
    return f"{ms:.{len(digits.split('.')[1])}f}"


def test_kernel_bounds_reproduce_perf_md():
    """kernel_bounds, moved from chip_smoke.py into the package with the
    batch as an argument, gives every bound of PERF.md section 6's two
    tables as printed, at the flagship and the EMPIAR shape."""
    for cfg, shard, table in (
            (TOOL.build("mnist")[0], 6144, FLAGSHIP_BOUNDS),
            (TOOL.build("particles-ctf")[0], 0, EMPIAR_BOUNDS)):
        got = flops.kernel_bounds(cfg, 100, shard)
        for name, (ms, by) in table.items():
            assert (_printed(got[name][0], ms), got[name][1]) == (ms, by), name
    emp = TOOL.build("particles-ctf")[0]
    emp2 = dataclasses.replace(emp, generator=dataclasses.replace(
        emp.generator, n_out=2))
    got = flops.kernel_bounds(emp2, 100)
    assert _printed(got["pose_decoder_fwd"][0], "1.927") == "1.927"
    assert _printed(got["pose_decoder_bwd"][0], "3.854") == "3.854"
    # K13, counted apart from kernel_bounds: the flagship's lift
    assert (_printed(flops.lift_conv_bound(TOOL.build("mnist")[0], 100)[0],
                     "0.247"), flops.lift_conv_bound(
                         TOOL.build("mnist")[0], 100)[1]) == (
        "0.247", "operations")


def test_r1_and_shard_bounds_reproduce_perf_md():
    """r1_bounds at mode B's shapes (B = 100, 2,601 positions, KI = 128 at
    groupconv 0 and 1,024 at 8) and shard_bounds at its SP shard of 2,048
    cells: PERF.md section 6's R = 1 rows."""
    n = 100 * 2601
    for ki, fwd, bwd in ((128, "0.0221", "0.042"), (1024, "0.161", "0.320")):
        got = flops.r1_bounds(n, ki, 128, 7, 100, 2601, 2)
        assert _printed(got["mix_heads_r1_fwd"][0], fwd) == fwd
        assert _printed(got["mix_heads_r1_bwd"][0], bwd) == bwd
        assert got["mix_heads_r1_fwd"][1] == got["mix_heads_r1_bwd"][1] \
            == "bytes"
    got = flops.r1_bounds(0, 8, 16, 1, 100, 2601, 2)
    assert _printed(got["posterior_fwd"][0], "0.0022") == "0.0022"
    assert _printed(got["posterior_bwd"][0], "0.0043") == "0.0043"
    got = flops.shard_bounds(100, 2, 2048)
    assert _printed(got["posterior_shard_fwd"][0], "0.0020") == "0.0020"
    assert _printed(got["posterior_shard_bwd"][0], "0.0039") == "0.0039"


def test_bound_takes_the_larger_time():
    assert flops.bound(flops.HBM_BPS, 0, flops.PEAK_BF16) == (1e3, "bytes")
    assert flops.bound(0, 2 * flops.PEAK_BF16, flops.PEAK_BF16) == (
        2e3, "operations")


# ---- the JAX package's own anchors (tests/test_flops.py) ----

def test_flagship_lift_conv_matches_anchor():
    """The flagship's lift forward, ~244 GFLOP at batch 100 (fwd + wgrad
    stored, 2x)."""
    fwd = flops.encoder_flops(TOOL.build("mnist")[0], 100)["lift_conv"] / 2
    assert abs(fwd - 244e9) / 244e9 < 0.03


def test_empiar_lift_and_step_match_anchors():
    """The EMPIAR lift forward ~2.62 TFLOP and the step 7-9.5 TFLOP at
    batch 50, with the CTF."""
    cfg = TOOL.build("particles-ctf")[0]
    fwd = flops.encoder_flops(cfg, 50)["lift_conv"] / 2
    assert abs(fwd - 2.62e12) / 2.62e12 < 0.03
    assert 7e12 < flops.step_flops(cfg, 50, ctf_dim=109)["total"] < 9.5e12


def test_mode_b_counts_single_rotation_when_groupconv_0():
    cfg = TOOL.build("mnist-b")[0]
    assert flops.encoder_flops(cfg, 100)["lift_conv"] == \
        2 * 2 * 100 * 51 * 51 * 2500 * 128


def test_mode_a_mlp_counts():
    ecfg = EncoderConfig(t_inf="unimodal", r_inf="unimodal", image_dim=50,
                         in_channels=1, z_dim=2, kernels_num=500,
                         num_layers=2)
    n, h, latent = 2500, 500, 5
    assert flops.encoder_flops(ModelConfig(encoder=ecfg), 10)[
        "encoder_mlp"] == 2 * 10 * n * h * 2 + 2 * 10 * (
            h * h + h * 2 * latent) * 3


def test_decoder_scales_with_pixels_and_depth():
    cfg = TOOL.build("mnist")[0]
    base = flops.decoder_flops(cfg, 100)["decoder_mlp"]
    deeper = dataclasses.replace(cfg, generator=dataclasses.replace(
        cfg.generator, num_layers=4))
    assert flops.decoder_flops(deeper, 100)["decoder_mlp"] > base
    assert flops.decoder_flops(cfg, 200)["decoder_mlp"] > 1.9 * base


def test_mfu_and_tier_peaks():
    """mfu is FLOPs / (seconds x peak); the bf16 tier reads against 989
    TFLOP/s, the float32 tier against TF32's 495 (cuDNN's convolutions'
    default), NVIDIA's H100 SXM figures. The flagship's 1.795 TFLOP in a
    patch-tier step of 8.29 ms is 21.9 %."""
    assert flops.mfu(flops.PEAK_BF16, 1.0, flops.PEAK_BF16) == 1.0
    assert flops.mfu(1.795e12, 8.29e-3, flops.PEAK_BF16) == pytest.approx(
        1.795e12 / (8.29e-3 * 989e12))
    assert round(flops.mfu(1.795e12, 8.29e-3, flops.PEAK_BF16), 3) == 0.219
    assert flops.tier_peak("bfloat16") == 989e12
    assert flops.tier_peak(None) == flops.tier_peak("float32") == 495e12
    assert (flops.PEAK_F32, flops.HBM_BPS) == (67e12, 3.35e12)
