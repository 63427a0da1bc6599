"""clock64 probe of the decoder's forward, K9 (and K7 beside it), on the card.

Builds targetvae_tpu_torch/csrc/ with -DTVAE_PROBE into a library of its own
beside the normal one (kernels/_build.py), runs K9 (decoder_mlp_fwd, the
features bf16(cos(phase)) built on chip) and K7 (the pose decoder's forward,
the features from per-image tables) at the flagship decode shape, 100 posed
50x50 grids (F = 1,024, hidden 512, 2 layers, one output) on seeded random
weights, and prints for each kernel, per 64-pixel tile (thread 0 of
consumer warpgroup 0, and builder thread 0, summed over the blocks): the
cycles layer 1 waited for feature slices, layer 1 in all, the hidden
layers' products, the epilogues and the heads; the builder's cycles
building slices and waiting for a free slice buffer; K9's consumer
thread's cycles building its rows of the next slice; with the kernel's
time under the probe (CUDA events) and the card's name and power limit.
Needs a CUDA device; run from the repository root:

    python3 tools/probe_decoder_mlp.py [--act leakyrelu|tanh] [--reps 10]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--act", default="leakyrelu", choices=("leakyrelu", "tanh"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: the probe runs only on a GPU", flush=True)
        return 1
    from targetvae_tpu_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for row in probe(_build.build(("-DTVAE_PROBE",)), args.act, args.reps):
        print(json.dumps(row), flush=True)
    return 0


def probe(lib_path, act_kind: str, reps: int) -> list:
    """One row a kernel (K9, K7) of the probe's cycles a tile, from the
    library at lib_path (built with -DTVAE_PROBE)."""
    import torch
    from targetvae_tpu_torch.kernels import _build
    from targetvae_tpu_torch.kernels.decoder_pose import ACT_CODES, pose_tables
    from targetvae_tpu_torch.models.generator import generator_init
    from targetvae_tpu_torch.ops.coords import image_grid, transform_coords
    from targetvae_tpu_torch.utils.config import GeneratorConfig

    lib = ctypes.CDLL(str(lib_path))
    for name in ("tvae_decoder_mlp_fwd", "tvae_pose_decoder_fwd"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    B, n = 100, 50                                      # the flagship decode
    cfg = GeneratorConfig(z_dim=2, hidden_dim=512, num_layers=2, n_out=1,
                          activation=act_kind, fourier_expansion=True,
                          fourier_sigma=2 / (n - 1), embedding_dim=1024)
    gp = generator_init(torch.Generator().manual_seed(0), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    theta = torch.randn(B, generator=gen, device=dev)
    dx = torch.randn((B, 2), generator=gen, device=dev) * 0.2
    z = torch.randn((B, 2), generator=gen, device=dev)
    wf = gp["fourier"]["w"] / cfg.fourier_sigma
    bfv = gp["fourier"]["b"]
    x = transform_coords(torch.as_tensor(image_grid(n), device=dev), dx,
                         theta).contiguous()
    u, v, p, q = pose_tables(theta, dx, wf, bfv, n)
    wmax = torch.cat([wf.abs().amax(1), bfv.abs().amax()[None]])
    bf = torch.bfloat16
    hz = z @ gp["latent_linear"]["w"]
    w1, b1 = gp["coord_linear"]["w"].to(bf), gp["coord_linear"]["b"]
    wh = torch.stack([h["w"] for h in gp["hidden"]]).to(bf)
    bh = torch.stack([h["b"] for h in gp["hidden"]])
    w3, b3 = gp["out"]["w"].to(bf), gp["out"]["b"]
    F, H, L = w1.shape[0], w1.shape[1], wh.shape[0] + 1
    y = torch.empty((B, n * n, 1), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    act = ACT_CODES[act_kind]
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    calls = {
        "decoder_mlp_fwd": ("tvae_probe_decoder_mlp_fwd", lambda: lib.tvae_decoder_mlp_fwd(
            *ptr(x, wf, bfv, wmax, hz, w1, b1, wh, bh, w3, b3, y), None,
            B, n * n, F, H, L, 1, act, stream)),
        "pose_decoder_fwd": ("tvae_probe_pose_decoder_fwd", lambda: lib.tvae_pose_decoder_fwd(
            *ptr(u, v, p, q, hz, w1, b1, wh, bh, w3, b3, y), None,
            B, n, F, H, L, 1, act, stream)),
    }
    rows = []
    sums = (ctypes.c_ulonglong * 10)()
    for name, (reader, fn) in calls.items():
        getattr(lib, reader).argtypes = [ctypes.c_void_p]
        if fn():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        getattr(lib, reader)(ctypes.addressof(sums))        # zeroes them
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        if getattr(lib, reader)(ctypes.addressof(sums)):
            raise RuntimeError(f"{name}: reading the probe failed")
        tiles = max(1, sums[5])
        rows.append({
            "kernel": name, "act": act_kind,
            "ms_under_probe": t0.elapsed_time(t1) / reps,
            "cycles_per_tile": {"layer1_waiting_for_features": sums[0] / tiles,
                                "layer1_in_all": sums[1] / tiles,
                                "hidden_products": sums[2] / tiles,
                                "epilogues": sums[3] / tiles,
                                "heads": sums[4] / tiles,
                                "builder_building": sums[6] / tiles,
                                "builder_waiting_for_buffer": sums[7] / tiles,
                                "consumer_building": sums[8] / tiles}})
    return rows


if __name__ == "__main__":
    sys.exit(main())
