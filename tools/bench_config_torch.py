#!/usr/bin/env python
"""Per-config training-step benchmark of the PyTorch port on one GPU.

    python3 tools/bench_config_torch.py CONFIG [--tier conv|patch]
        [--batch N] [--steps N] [--windows N] [--f32] [--history PATH]
        [--device cuda|cpu]

CONFIG is one of tools/bench_config.py's nine, built from the port's config
classes with that tool's default batches: mnist (the flagship), mnist-p16,
mnist-a, mnist-b, mnist-b-p8, dsprites, galaxy, particles, particles-ctf.
Times Trainer.train_step (the ELBO's forward and backward, Adam) on seeded
uniform images; particles-ctf also feeds a CTF table of the whole batch in
ctf_filter's units (parallel/dryrun.py::ctf_kernels: defocus 1.0-2.5 um,
amplitude contrast 7 %, 1.5 A a pixel, kernels of image_dim - 1). The bf16
kernel tier by default (--f32: the float32 tier); --tier patch runs mode C's
patch encoder (K11/K12). After WARMUP steps, --windows windows of --steps
steps each between CUDA events: ms/step is the median window. Prints one
JSON line (ms/step, img/s, TFLOP/step by targetvae_tpu_torch/utils/
flops.py::step_flops, MFU against the tier's peak (flops.tier_peak), each
kernel's launches a step, the card's name and power limit) and records it
through utils/bench_log.py (bench_results_torch.jsonl at the root unless
--history). An MFU above 1 raises: the count would be wrong. --device cpu
runs the kernels' plain versions on the CPU, timed by the host clock, with
no MFU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = ("mnist", "mnist-p16", "mnist-a", "mnist-b", "mnist-b-p8",
           "dsprites", "galaxy", "particles", "particles-ctf")
DEFAULT_BATCH = {"mnist": 100, "mnist-p16": 100, "mnist-a": 100,
                 "mnist-b": 100, "mnist-b-p8": 100, "dsprites": 50,
                 "galaxy": 50, "particles": 50, "particles-ctf": 50}
WARMUP = 2
CTF_APIX = 1.5       # A a pixel of the particles-ctf table


def build(name: str):
    """(ModelConfig, image_dim, channels, with_ctf) of a config, field by
    field tools/bench_config.py::build's (which returns the CTF table where
    this returns whether there is one: ctf_table builds it for a batch)."""
    import numpy as np
    from targetvae_tpu_torch.utils.config import (
        EncoderConfig, GeneratorConfig, LikelihoodConfig, ModelConfig)

    def gen(d, sigma=None, n_out=1, layers=2):
        return GeneratorConfig(z_dim=2, hidden_dim=512, n_out=n_out,
                               num_layers=layers, fourier_expansion=True,
                               fourier_sigma=sigma or 2.0 / (d - 1))

    bernoulli = LikelihoodConfig(kind="bernoulli")
    if name in ("mnist", "mnist-p16"):
        # the flagship (__graft_entry__._flagship_config), P16: the finest
        # rotation grid the reference exposes
        enc = EncoderConfig(t_inf="attention", r_inf="attention+offsets",
                            image_dim=50, in_channels=1, z_dim=2,
                            kernels_num=128, kernels_size=28, padding=8,
                            groupconv=16 if name == "mnist-p16" else 8,
                            theta_prior=np.pi, normal_prior_over_r=False)
        return ModelConfig(gen(50), enc, bernoulli), 50, 1, False
    if name == "mnist-a":
        enc = EncoderConfig(t_inf="unimodal", r_inf="unimodal", image_dim=50,
                            in_channels=1, z_dim=2, kernels_num=128,
                            num_layers=2, theta_prior=np.pi)
        return ModelConfig(gen(50), enc, bernoulli), 50, 1, False
    if name in ("mnist-b", "mnist-b-p8"):
        enc = EncoderConfig(t_inf="attention", r_inf="unimodal", image_dim=50,
                            in_channels=1, z_dim=2, kernels_num=128,
                            groupconv=8 if name.endswith("p8") else 0,
                            theta_prior=np.pi)
        return ModelConfig(gen(50), enc, bernoulli), 50, 1, False
    if name == "dsprites":
        enc = EncoderConfig(t_inf="attention", r_inf="attention+offsets",
                            image_dim=64, in_channels=1, z_dim=2,
                            kernels_num=128, kernels_size=64, padding=32,
                            groupconv=8, theta_prior=np.pi,
                            normal_prior_over_r=False)
        return ModelConfig(gen(64, sigma=0.01), enc, bernoulli), 64, 1, False
    if name == "galaxy":
        enc = EncoderConfig(t_inf="attention", r_inf="attention+offsets",
                            image_dim=64, in_channels=3, z_dim=2,
                            kernels_num=128, kernels_size=65, padding=16,
                            groupconv=8, theta_prior=np.pi,
                            normal_prior_over_r=False)
        return (ModelConfig(gen(64, n_out=3, layers=4), enc, bernoulli),
                64, 3, False)
    if name in ("particles", "particles-ctf"):
        with_ctf = name == "particles-ctf"
        enc = EncoderConfig(t_inf="attention", r_inf="attention+offsets",
                            image_dim=110, in_channels=1, z_dim=2,
                            kernels_num=128, kernels_size=64, padding=16,
                            groupconv=8, theta_prior=np.pi,
                            normal_prior_over_r=False)
        lik = LikelihoodConfig(kind="gaussian",
                               mask_radius=45 if with_ctf else 0)
        return ModelConfig(gen(110), enc, lik), 110, 1, with_ctf
    raise ValueError(f"unknown config {name!r}")


def ctf_table(batch: int, image_dim: int):
    """(batch, image_dim - 1, image_dim - 1) float32 CTF kernels, one a row
    of the batch, in ctf_filter's units (µm, percent)."""
    from targetvae_tpu_torch.parallel.dryrun import ctf_kernels
    return ctf_kernels(batch, image_dim, CTF_APIX)


def _device(device):
    """The torch.device of `device` ("cuda" is cuda:0); raises for a CUDA
    device where there is none."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run the "
                               "kernels' plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def make_step(name: str, batch: int = 0, f32: bool = False,
              device: str = "cuda", images=None):
    """(step, cfg, batch, ctf_dim): step() runs one Trainer.train_step of
    the config (random weights from seed 0, Adam at 2e-4) on seeded uniform
    images of `batch` (0: the config's default), or on `images` (batch, n,
    n, c) float32 where given, and, for particles-ctf, their CTF table
    (ctf_dim its kernel size, else None); it returns the step's metrics
    tensor without waiting for it."""
    import numpy as np
    import torch
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig

    cfg, n, c, with_ctf = build(name)
    batch = batch or DEFAULT_BATCH[name]
    dev = _device(device)
    trainer = Trainer(cfg, TrainConfig(
        learning_rate=2e-4, compute_dtype=None if f32 else "bfloat16",
        minibatch_size=batch), device=dev)
    state = trainer.init_state(0)
    if images is None:
        images = np.random.default_rng(1).random((batch, n, n, c),
                                                 np.float32)
    y = torch.from_numpy(images).to(dev)
    ctf = (torch.from_numpy(ctf_table(batch, n)).to(dev) if with_ctf
           else None)
    return (lambda: trainer.train_step(state, y, ctf=ctf)[1], cfg, batch,
            n - 1 if with_ctf else None)


@contextlib.contextmanager
def encoder_tier(tier: str):
    """TARGETVAE_ENCODER_TIER set to `tier` for the block, restored after
    it."""
    old = os.environ.get("TARGETVAE_ENCODER_TIER")
    os.environ["TARGETVAE_ENCODER_TIER"] = tier
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TARGETVAE_ENCODER_TIER", None)
        else:
            os.environ["TARGETVAE_ENCODER_TIER"] = old


def bench(name: str, batch: int = 0, steps: int = 10, windows: int = 5,
          f32: bool = False, tier: str = "conv", device: str = "cuda"
          ) -> dict:
    """One config's train step timed as the module says; returns the result
    entry (not recorded)."""
    import torch
    from targetvae_tpu_torch import kernels
    from targetvae_tpu_torch.utils import flops

    if tier not in ("conv", "patch"):
        raise ValueError(f"unknown tier {tier!r}")
    if tier == "patch" and (f32 or build(name)[0].encoder.mode != "C"):
        raise ValueError("--tier patch is mode C's bf16 encoder: "
                         f"{name}{' --f32' if f32 else ''} has none")
    step, cfg, batch, ctf_dim = make_step(name, batch, f32, device)
    dev = _device(device)
    cuda = dev.type == "cuda"
    dtype = "float32" if f32 else "bfloat16"
    with encoder_tier(tier):
        for _ in range(WARMUP):
            metrics = step()
        if not bool(torch.isfinite(metrics).all()):
            raise RuntimeError(f"{name}: the warm-up steps' metrics are not "
                               f"finite: {metrics.tolist()}")
        kernels.reset_launch_counts()
        ms = []
        for _ in range(windows):
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            else:
                t0 = time.perf_counter()
            for _ in range(steps):
                step()
            if cuda:
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end) / steps)
            else:
                ms.append((time.perf_counter() - t0) * 1e3 / steps)
        counts = kernels.launch_counts()
    ms_step = statistics.median(ms)
    fl = flops.step_flops(cfg, batch, ctf_dim)
    peak = flops.tier_peak(dtype)
    mfu = flops.mfu(fl["total"], ms_step / 1e3, peak) if cuda else None
    if mfu is not None and not 0 < mfu < 1:
        raise RuntimeError(f"{name}: MFU {mfu:.4f} outside (0, 1): "
                           f"{fl['total']:.4e} FLOP in {ms_step:.3f} ms at "
                           f"{peak:.3e} FLOP/s; the count is wrong")
    return {
        "config": name, "batch": batch, "dtype": dtype, "tier": tier,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "ms_per_step": ms_step, "ms_windows": ms, "steps": steps,
        "images_per_sec": batch / ms_step * 1e3,
        "tflops_per_step": fl["total"] / 1e12,
        "flops_breakdown": fl["breakdown"], "mfu": mfu,
        "peak": peak if cuda else None,
        "launches_per_step": {k: v / (windows * steps)
                              for k, v in counts.items() if v},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", choices=CONFIGS)
    ap.add_argument("--tier", choices=("conv", "patch"), default="conv")
    ap.add_argument("--batch", type=int, default=0,
                    help="default: tools/bench_config.py's for the config")
    ap.add_argument("--steps", type=int, default=10,
                    help="steps a timed window")
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--f32", action="store_true",
                    help="the float32 tier (default: bf16)")
    ap.add_argument("--history", default=None,
                    help="history file (default: bench_results_torch.jsonl "
                         "at the repository's root)")
    ap.add_argument("--device", default="cuda",
                    help="cuda, cuda:N or cpu (default: the card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from targetvae_tpu_torch.utils import bench_log
    result = bench(args.config, args.batch, args.steps, args.windows,
                   args.f32, args.tier, args.device)
    result = bench_log.record(result, args.history)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
