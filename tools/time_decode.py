"""Time bf16 decode on the card: TargetVAE.decode of 100 posed 50x50 grids.

Builds the flagship model (random weights from a seed) of the port found
under --root (a checkout of the repository; this one by default), decodes
the batch in bf16 with and without a gradient through it, and prints one
JSON line: img/s and device ms a batch of each (CUDA events, mean of 10
calls after a warm-up, the smaller of two runs), the launches of the
decoder kernel per call, and the card's name and power limit. Needs a CUDA
device:

    python3 tools/time_decode.py [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: the timing runs only on a GPU", flush=True)
        return 1
    import targetvae_tpu_torch.kernels as kernels
    from targetvae_tpu_torch import TargetVAE
    from targetvae_tpu_torch.ops.coords import image_grid, transform_coords
    sys.path.insert(1, HERE)
    from chip_smoke import cuda_ms, flagship_config

    dev = torch.device("cuda", 0)
    cfg = flagship_config()
    model = TargetVAE(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    B, n = 100, cfg.encoder.image_dim
    gen = torch.Generator(device=dev).manual_seed(3)
    theta = torch.randn(B, generator=gen, device=dev)
    dx = torch.randn((B, 2), generator=gen, device=dev) * 0.2
    z = torch.randn((B, cfg.encoder.z_dim), generator=gen, device=dev)
    x = transform_coords(torch.as_tensor(image_grid(n), device=dev), dx,
                         theta).contiguous()
    g = torch.randn(x.shape[:2] + (1,), generator=gen, device=dev)

    def grad_step():
        model.zero_grad(set_to_none=True)
        xx, zz = x.clone().requires_grad_(), z.clone().requires_grad_()
        model.decode(model.params(), xx, zz, torch.bfloat16).backward(g)

    with torch.inference_mode():
        serve = lambda: model.decode(params, x, z, torch.bfloat16)
        kernels.reset_launch_counts()
        serve()
        launches = kernels.launch_counts()["decoder_mlp_fwd"]
        fwd_ms = min(cuda_ms(serve), cuda_ms(serve))
    grad_ms = min(cuda_ms(grad_step), cuda_ms(grad_step))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "root": os.path.abspath(args.root),
                      "batch": B, "pixels": n * n,
                      "decode_img_s": B / fwd_ms * 1e3, "decode_ms": fwd_ms,
                      "decode_grad_img_s": B / grad_ms * 1e3,
                      "decode_grad_ms": grad_ms,
                      "decoder_mlp_fwd_launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
