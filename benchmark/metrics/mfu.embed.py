"""The embed's share of the H100's bf16 peak: the frozen forward count of
the encoder over every batch embedded in the window, over its seconds."""

from benchmark.counts import flops


def read(trace):
    run = trace.run
    if run.kind != "embed" or trace.window_s <= 0:
        return None
    total = sum(c * flops.encoder_forward_flops(run.model, b)
                for b, c in run.batches.items())
    return 100.0 * flops.mfu(total, trace.window_s, flops.PEAK_BF16)
