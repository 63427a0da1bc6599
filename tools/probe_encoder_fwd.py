"""clock64 probe of the encoder's forward chain, K1 and K11, and of mode B's
R = 1 chain, K1 and K2 at R = 1, on the card.

Builds targetvae_tpu_torch/csrc/ with -DTVAE_PROBE into a library of its own
beside the normal one (kernels/_build.py), runs K1 (mix_heads_fwd) and K11
(lifted_encoder_fwd, serving) at the flagship shape on seeded random inputs,
and prints for each kernel, per work item (128 positions, one rotation) of
thread 0 of consumer warpgroup 0, summed over the blocks: the cycles spent
waiting for a ring stage, in K11's lift mainloop (its waits included), and
in the rest of the item (h1's epilogue, pre2, h2, the heads and their
store; its parts but h1's epilogue also one by one), with the kernel's time under the probe (CUDA events) and the card's
name and power limit. With --r1 it runs instead mix_heads_r1_fwd and
mix_heads_r1_bwd (through their wrappers, on the probe's library) at mode
B's two shapes (N = 260,100 positions, K = 128, D = 7; KI = 128 and 1,024)
and prints, for each kernel (or pass) that ran, the cycles a work item of
thread 0 of consumer warpgroup 0 spends waiting for ring stages, in the
mainloop, in the epilogue and in the stores (csrc/mix_heads_r1.cu names
each segment). Needs a CUDA device; run from the repository root:

    python3 tools/probe_encoder_fwd.py [--act leakyrelu|tanh] [--reps 10] [--r1]
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
    ap.add_argument("--r1", action="store_true",
                    help="probe mode B's K1 and K2 at R = 1 instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL no CUDA device: the probe runs only on a GPU", flush=True)
        return 1
    from targetvae_tpu_torch.kernels import _build
    from targetvae_tpu_torch.kernels.decoder_pose import ACT_CODES
    from targetvae_tpu_torch.kernels.mix_heads import fwd_schedule

    lib = ctypes.CDLL(str(_build.build(("-DTVAE_PROBE",))))
    if args.r1:
        return probe_r1(torch, lib, _build, args)
    for name in ("tvae_mix_heads_fwd", "tvae_lifted_encoder_fwd"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    n, R, K, D, ck = 100 * 39 * 39, 8, 128, 7, 784     # the flagship
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)
    bf = torch.bfloat16
    pre1 = (rn(n, R * K) * 0.5).to(bf)
    p = torch.rand((n, ck), generator=gen, device=dev).to(bf)
    wc = (rn(ck, R * K) * 0.05).to(bf)
    bc, w2, b2 = rn(R * K) * 0.1, (rn(K, K) * 0.05).to(bf), rn(K) * 0.1
    wh, bh = (rn(K, D) * 0.1).to(bf), rn(D) * 0.1
    out = torch.empty((n, R * D), device=dev)
    blocks, chunk = fwd_schedule(n, R, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    act = ACT_CODES[args.act]
    calls = {
        "mix_heads_fwd": ("tvae_probe_mix_heads_fwd", lambda: lib.tvae_mix_heads_fwd(
            pre1.data_ptr(), bc.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            wh.data_ptr(), bh.data_ptr(), out.data_ptr(), n, R, K, D, blocks,
            chunk, act, stream)),
        "lifted_encoder_fwd": ("tvae_probe_lifted_encoder_fwd", lambda: lib.tvae_lifted_encoder_fwd(
            p.data_ptr(), wc.data_ptr(), bc.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), wh.data_ptr(), bh.data_ptr(), out.data_ptr(), None,
            n, ck, R, K, D, blocks, chunk, act, stream)),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    sums = (ctypes.c_ulonglong * 8)()
    for name, (reader, fn) in calls.items():
        getattr(lib, reader).argtypes = [ctypes.c_void_p]
        if fn():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        getattr(lib, reader)(ctypes.addressof(sums))        # zeroes them
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(args.reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        if getattr(lib, reader)(ctypes.addressof(sums)):
            raise RuntimeError(f"{name}: reading the probe failed")
        items = max(1, sums[3])
        print(json.dumps({
            "kernel": name, "act": args.act, "grid": [blocks, chunk],
            "ms_under_probe": t0.elapsed_time(t1) / args.reps,
            "cycles_per_item": {"waiting_for_stages": sums[0] / items,
                                "lift_mainloop": sums[1] / items,
                                "rest_of_item": sums[2] / items,
                                "of_which_pre2_product": sums[4] / items,
                                "of_which_h2_epilogue": sums[5] / items,
                                "of_which_heads_product": sums[6] / items,
                                "of_which_heads_stores": sums[7] / items}}),
              flush=True)
    return 0


# the R = 1 probe's groups of six sums (csrc/mix_heads_r1.cu, r1_probe):
# a kernel, its work item, then the names of its five cycle segments
R1_GROUPS = (
    ("K1 R=1", "tile (64 positions with W2 resident, else 128)",
     ("waiting_for_stages", "mainloop", "epilogue", "stores", None)),
    ("K2 R=1 head pass", "tile of 128 positions",
     ("waiting_for_stages", "mainloop", "epilogue", "stores", None)),
    ("K2 R=1 channel pass", "tile of 128 positions, 64 channels",
     ("waiting_for_stages", "products", "dpre1_epilogue", "stores",
      "dW2_product_wait")),
)


def probe_r1(torch, lib, _build, args) -> int:
    """K1 and K2 at R = 1 through their wrappers on the probe's library, at
    KI = 128 and 1,024; prints one JSON line a kernel (or pass) that ran."""
    import targetvae_tpu_torch.kernels.mix_heads as mh
    for name, argtypes in _build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    _build.library = lambda: lib
    reader = lib.tvae_probe_mix_heads_r1
    reader.argtypes = [ctypes.c_void_p]
    sums = (ctypes.c_ulonglong * 18)()
    dev = torch.device("cuda", 0)
    n, K, D = 100 * 51 * 51, 128, 7
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for ki in (128, 1024):
        gen = torch.Generator(device=dev).manual_seed(0)
        rn = lambda *s: torch.randn(s, generator=gen, device=dev)
        bf = torch.bfloat16
        args1 = ((rn(n, ki) * 0.5).to(bf), rn(ki) * 0.1,
                 (rn(ki, K) * 0.05).to(bf), rn(K) * 0.1,
                 (rn(K, D) * 0.1).to(bf), rn(D) * 0.1)
        g = rn(n, D) * 1e-2
        calls = {"mix_heads_r1_fwd": lambda: mh.mix_heads_r1_fwd(
                     *args1, K=K, act_kind=args.act),
                 "mix_heads_r1_bwd": lambda: mh.mix_heads_r1_bwd(
                     *args1[:5], g, K=K, act_kind=args.act)}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            if reader(ctypes.addressof(sums)):            # zeroes them
                raise RuntimeError("reading the probe failed")
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(args.reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
            if reader(ctypes.addressof(sums)):
                raise RuntimeError("reading the probe failed")
            for k, (group, item, segs) in enumerate(R1_GROUPS):
                items = sums[6 * k]
                if not items:
                    continue
                print(json.dumps({
                    "kernel": group, "call": name, "KI": ki, "N": n,
                    "act": args.act, "item": item,
                    "items_per_call": items / args.reps,
                    "ms_under_probe": t0.elapsed_time(t1) / args.reps,
                    "cycles_per_item": {seg: sums[6 * k + 1 + j] / items
                                        for j, seg in enumerate(segs)
                                        if seg}}), flush=True)
        del args1, g
    return 0


if __name__ == "__main__":
    sys.exit(main())
