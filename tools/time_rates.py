#!/usr/bin/env python
"""Time the flagship's serving and training rates on the card, as
chip_smoke.py's phases 5 and 8 take them, for the port under --root (a
checkout of the repository; this one by default), so that two checkouts
can be timed one after the other in one call.

On each encoder tier (conv: the lift and K1/K2; patch: K11/K12) of
the flagship model (random weights from a seed): embed img/s
(embed_dataset over 1,000 synthetic images, bf16, host to host, after a
warm-up; --reps readings), eval img/s (the sampled bf16 ELBO of a batch of
100, CUDA events, mean of 10 calls) and train img/s (Trainer.train_step,
bf16, B = 100, CUDA events, mean of 10 steps; --reps readings). Prints one
JSON line with every reading and the card's name and power limit. Needs a
CUDA device:

    python3 tools/time_rates.py [--root DIR] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: the timing runs only on a GPU", flush=True)
        return 1
    from targetvae_tpu_torch.cli.clustering_common import embed_dataset
    from targetvae_tpu_torch.train import Trainer
    from targetvae_tpu_torch.utils.config import TrainConfig
    sys.path.insert(1, HERE)
    from chip_smoke import (B, N_EMBED, cuda_ms, encoder_tier,
                            flagship_config, synthetic_images)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = flagship_config()
    trainer = Trainer(cfg, TrainConfig(compute_dtype="bfloat16",
                                       minibatch_size=B), device=dev)
    state = trainer.init_state(0)
    model = trainer.model
    images = synthetic_images(N_EMBED, cfg.encoder.image_dim, 2)
    yb = torch.from_numpy(images[:B]).to(dev)
    x_coord = model.base_grid()
    gen = torch.Generator().manual_seed(5)
    out = {}
    for tier in ("conv", "patch"):
        with encoder_tier(tier):
            with torch.inference_mode():
                params = model.params()
                embed_dataset(model, params, images, B, "bfloat16")
                embed = []
                for _ in range(args.reps):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    embed_dataset(model, params, images, B, "bfloat16")
                    torch.cuda.synchronize()
                    embed.append(N_EMBED / (time.perf_counter() - t))
                eval_ms = cuda_ms(lambda: model.elbo(params, x_coord, yb, gen,
                                                     torch.bfloat16))
            train = [B / cuda_ms(lambda: trainer.train_step(state, yb)) * 1e3
                     for _ in range(args.reps)]
        out[tier] = {"embed_img_s": embed, "eval_img_s": B / eval_ms * 1e3,
                     "train_img_s": train}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root), "card": smi,
                      **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
