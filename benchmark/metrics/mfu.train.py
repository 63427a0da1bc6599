"""The train step's share of the H100's bf16 peak: the frozen step_flops
of every step of the window (full batches and tails) over the window's
seconds."""

from benchmark.counts import flops


def read(trace):
    run = trace.run
    if run.kind != "train" or trace.window_s <= 0:
        return None
    total = sum(c * flops.step_flops(run.model, b, run.ctf_dim)["total"]
                for b, c in run.batches.items())
    return 100.0 * flops.mfu(total, trace.window_s, flops.PEAK_BF16)
