"""clock64 probe of the encoder's forward chain, K1 and K11, on the card.

Builds targetvae_tpu_torch/csrc/ with -DTVAE_PROBE into a library of its own
beside the normal one (kernels/_build.py), runs K1 (mix_heads_fwd) and K11
(lifted_encoder_fwd, serving) at the flagship shape on seeded random inputs,
and prints for each kernel, per work item (128 positions, one rotation) of
thread 0 of consumer warpgroup 0, summed over the blocks: the cycles spent
waiting for a ring stage, in K11's lift mainloop (its waits included), and
in the rest of the item (h1's epilogue, pre2, h2, the heads and their
store; its parts but h1's epilogue also one by one), with the kernel's time under the probe (CUDA events) and the card's
name and power limit. Needs a CUDA device; run from the repository root:

    python3 tools/probe_encoder_fwd.py [--act leakyrelu|tanh] [--reps 10]
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
    from targetvae_tpu_torch.kernels.decoder_pose import ACT_CODES
    from targetvae_tpu_torch.kernels.mix_heads import fwd_schedule

    lib = ctypes.CDLL(str(_build.build(("-DTVAE_PROBE",))))
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


if __name__ == "__main__":
    sys.exit(main())
