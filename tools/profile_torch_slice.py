#!/usr/bin/env python3
"""Profile the PyTorch port's flagship paths on one GPU.

    python3 tools/profile_torch_slice.py

Runs torch.profiler over a few steady-state batches of the bf16 train step
(forward, backward through the K2/K4/K8 kernels, Adam), the bf16 held-out
ELBO and bf16 embed at the flagship width (random weights from a seed,
synthetic images) and prints, for each: device time per batch, the device
busy share of the wall time, and the kernels by total device time. Needs a
CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from targetvae_tpu_torch import TargetVAE  # noqa: E402
from targetvae_tpu_torch.train import Trainer  # noqa: E402
from targetvae_tpu_torch.utils.config import TrainConfig  # noqa: E402

B = 100       # batch, as chip_smoke.py
STEPS = 5     # profiled batches after two warm-up batches


def profile_fn(name, fn, steps, top=15):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    print(f"== {name}: wall {wall / steps * 1e3:.3f} ms/batch, device "
          f"{dev_us / steps / 1e3:.3f} ms/batch, busy share "
          f"{dev_us / 1e6 / wall:.3f}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / steps / 1e3:9.4f} ms/batch "
              f"{e.count // steps:4d}x  {e.key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    cfg = chip_smoke.flagship_config()
    model = TargetVAE(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    y = torch.from_numpy(chip_smoke.synthetic_images(
        B, cfg.encoder.image_dim, 2)).to(dev)
    x = model.base_grid()
    gen = torch.Generator().manual_seed(5)
    trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                       minibatch_size=B), device=dev)
    state = trainer.init_state(0)
    profile_fn("train step (bf16, Adam)",
               lambda: trainer.train_step(state, y), STEPS, top=25)
    with torch.inference_mode():
        profile_fn("eval (ELBO, bf16)", lambda: model.elbo(
            params, x, y, gen, torch.bfloat16), STEPS)
        profile_fn("embed (bf16)", lambda: model.embed(
            params, y, torch.bfloat16), STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
