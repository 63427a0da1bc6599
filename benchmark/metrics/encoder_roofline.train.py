"""The encoder's and the posterior's kernels of a train step: K1/K2
(kernels/mix_heads.py) on the conv tier or K11/K12
(kernels/lifted_encoder.py) on the patch tier, and K3/K4
(kernels/posterior.py): the frozen bound of every launch over the device
time of the port's kernels launched under their autograd Functions."""

from benchmark import readers

WRAPPERS = ["mix_heads_fwd", "mix_heads_bwd", "lifted_encoder_fwd",
            "lifted_encoder_bwd", "posterior_fwd", "posterior_bwd"]
OWNERS = {readers.FUNCTIONS[w] for w in WRAPPERS}


def read(trace):
    if trace.run.kind != "train":
        return None
    return readers.roofline(
        trace, WRAPPERS, lambda op: readers.port_kernel(op)
        and readers.launched_under(op, OWNERS))
