"""The encoder kernel of an embed, K1 (kernels/mix_heads.py, conv tier) or
K11 (kernels/lifted_encoder.py, patch tier): the frozen bound of every
launch over the device time of the port's kernels in the window (an embed
launches no other; K11 runs outside an autograd Function there)."""

from benchmark import readers

WRAPPERS = ["mix_heads_fwd", "lifted_encoder_fwd"]


def read(trace):
    if trace.run.kind != "embed":
        return None
    return readers.roofline(trace, WRAPPERS, readers.port_kernel)
