#!/usr/bin/env python3
"""Read the port's bf16-vs-float32 gradient distance on mode B's theta heads.

    python3 tools/read_mode_b_grad_gap.py [--seeds 8] [--batches 10 25 100]
    python3 tools/read_mode_b_grad_gap.py --from DIR

The port's counterpart of tools/calibrate_mode_b_grad_tol.py, which reads
the JAX package's bf16 TPU tier on the CPU. For mnist-b and mnist-b-p8 at
full width (chip_smoke.mode_config), for each batch size and each seed s:
weights from the port's initialiser at seed s, the images
chip_smoke.synthetic_images(batch, 50, 3 + s) (the JAX tool's images), and
one deterministic step's gradients of -ELBO on the bf16 tier (K1/K2 at
R = 1, K3/K4, K7/K8) and the float32 tier; prints the relative L2 distance
of the theta heads (encoder.conv_r) and the largest over every other leaf
but the attention bias (whose exact gradient is zero) for each, and one
JSON line with the card's name and power limit. With --from DIR it reads
instead the inputs tools/calibrate_mode_b_grad_tol.py --dump DIR wrote (the
JAX package's weights and images), and prints the port's distances beside
the JAX package's on each. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from targetvae_tpu_torch import TargetVAE  # noqa: E402
from targetvae_tpu_torch.losses.elbo import compute_elbo  # noqa: E402
from targetvae_tpu_torch.utils.jax_params import params_from_jax  # noqa: E402


def gaps(name: str, seed: int, batch: int, dev, dumped=None) -> dict:
    """rel L2 of the bf16 tier's gradients against the float32 tier's, per
    leaf, one deterministic step; on a dumped reading's weights and images
    where one is given."""
    cfg = cs.mode_config(name)
    model = TargetVAE(cfg, device=dev)
    if dumped is None:
        model.init(torch.Generator().manual_seed(seed))
        images = cs.synthetic_images(batch, 50, 3 + seed)
    else:
        model.load_params(params_from_jax(dumped["params"], dev))
        images = dumped["images"]
    y = torch.from_numpy(images).to(dev)
    x_coord = model.base_grid()

    def grads(dt):
        model.zero_grad(set_to_none=True)
        (-compute_elbo(model.params(), cfg, x_coord, y, None, dt)[0]
         ).backward()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}

    g16, g32 = grads(torch.bfloat16), grads(None)
    return {n: cs.rel_l2(g16[n], g32[n]) for n in g32}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--batches", type=int, nargs="+", default=[10, 25, 100])
    ap.add_argument("--from", dest="dumped", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: the reading runs only on a GPU", flush=True)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = {}
    for path in sorted(glob.glob(os.path.join(args.dumped, "*.pkl"))
                       if args.dumped else []):
        with open(path, "rb") as f:
            d = pickle.load(f)
        g = gaps(d["config"], d["seed"], len(d["images"]), dev, d)
        j = {n.replace("/", ".").replace("generator.", "spatial_generator.",
                                         1): v
             for n, v in d["jax_gaps"].items()}
        theta = {n: (round(j[n], 4), round(v, 4)) for n, v in g.items()
                 if "conv_r" in n}
        report[os.path.basename(path)] = {"jax": j, "port": g}
        print(f"{os.path.basename(path)}: theta heads (JAX {d['tier']} tier "
              f"on the CPU, port on the card): {theta}", flush=True)
    for name in () if args.dumped else ("mnist-b", "mnist-b-p8"):
        for batch in args.batches:
            theta, rest = [], []
            for s in range(args.seeds):
                g = gaps(name, s, batch, dev)
                theta.append(max(v for n, v in g.items() if "conv_r" in n))
                rest.append(max(v for n, v in g.items() if "conv_r" not in n
                                and n != "encoder.conv_a.b"))
            report[f"{name} B={batch}"] = {"theta_heads": theta,
                                           "others": rest}
            print(f"{name}, {batch} images, seeds 0-{args.seeds - 1}: theta "
                  f"heads {[round(v, 4) for v in theta]}, largest other leaf "
                  f"{max(rest):.4f}", flush=True)
    print(json.dumps({"device": smi, "seeds": args.seeds, "gaps": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
