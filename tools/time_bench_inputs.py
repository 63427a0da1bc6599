#!/usr/bin/env python
"""Time configs' bf16 train steps on three image batches, in turns, with
the card's SM clock and power draw sampled during each window: the
uniform images of tools/bench_config_torch.py, chip_smoke.synthetic_images'
strokes as that function returns them (numpy gives their channel axis
stride 0), and the same strokes copied (channel stride 1, as the uniform
array and the epoch loop's index_select batches have). The step's
arithmetic depends on neither the values nor the strides; which cuDNN
kernels run the lift's weight gradient (and the lift itself, where K13
does not take the shape) can depend on the strides.

    python3 tools/time_bench_inputs.py [CONFIG ...] [--rounds 2]
        [--steps 10]

CONFIG: single-channel configs of tools/bench_config_torch.py (default:
mnist-b-p8 mnist-b mnist; mode C on the conv tier). Each round times each
input once (--steps steps between CUDA events after two steps of
warm-up); then a profiler trace of --steps steps of each gives the device
ops that take the most time a step. Prints one JSON line: each input's
channel stride, ms/step, the median SM clock (MHz) and power draw (W) of
each window and its top device ops (name, ms a step), the card's name and
power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_OPS = 6          # device ops reported an input


def _tool():
    spec = importlib.util.spec_from_file_location(
        "bench_config_torch", os.path.join(REPO, "tools",
                                           "bench_config_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def sampled(fn):
    """fn() with nvidia-smi's SM clock and power draw read every 0.1 s
    meanwhile: (fn's result, median MHz, median W)."""
    stop, clocks, watts = threading.Event(), [], []

    def loop():
        while not stop.wait(0.1):
            mhz, w = _smi("clocks.sm,power.draw").split(",")
            clocks.append(float(mhz))
            watts.append(float(w))

    t = threading.Thread(target=loop)
    t.start()
    try:
        out = fn()
    finally:
        stop.set()
        t.join()
    med = lambda v: statistics.median(v) if v else None
    return out, med(clocks), med(watts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*",
                    default=["mnist-b-p8", "mnist-b", "mnist"])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL no CUDA device: the timing runs only on a GPU")
    from chip_smoke import device_ops, synthetic_images
    tool = _tool()
    out = {"card": _smi("name,power.limit"), "steps": args.steps}
    for name in args.configs:
        _, n, c, _ = tool.build(name)
        if c != 1:
            raise SystemExit(f"{name}: {c} channels; the strokes have one")
        b = tool.DEFAULT_BATCH[name]
        strokes = synthetic_images(b, n, 2)
        images = {"uniform": None, "strokes": strokes,
                  "strokes_copied": strokes.copy()}
        steps = {k: tool.make_step(name, images=v)[0]
                 for k, v in images.items()}
        rows = {k: [] for k in steps}
        rows["channel_stride"] = {
            k: (1 if v is None else v.strides[-1] // v.itemsize)
            for k, v in images.items()}
        with tool.encoder_tier("conv"):
            for step in steps.values():
                for _ in range(2):
                    step()
            for _ in range(args.rounds):
                for kind, step in steps.items():
                    def window():
                        start, end = (torch.cuda.Event(enable_timing=True)
                                      for _ in range(2))
                        start.record()
                        for _ in range(args.steps):
                            step()
                        end.record()
                        end.synchronize()
                        return start.elapsed_time(end) / args.steps
                    ms, mhz, w = sampled(window)
                    rows[kind].append({"ms_per_step": ms, "sm_mhz": mhz,
                                       "power_w": w})
            for kind, step in steps.items():
                per_op = {}
                for op, _, us, _ in device_ops(torch, step, args.steps):
                    per_op[op] = per_op.get(op, 0.0) + us / 1e3 / args.steps
                rows[kind + "_top_ops"] = [
                    [op[:90], round(ms, 4)] for op, ms in sorted(
                        per_op.items(), key=lambda kv: -kv[1])[:TOP_OPS]]
        out[name] = rows
        del steps
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
