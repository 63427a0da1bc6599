"""K7 and K8 (kernels/decoder_pose.py): the frozen bound of every launch in
the window over the device time of the port's kernels launched under their
autograd Functions (the reduction kernels included, the pose tables built
in PyTorch left out)."""

from benchmark import readers

WRAPPERS = ["pose_decoder_fwd", "pose_decoder_bwd"]
OWNERS = {readers.FUNCTIONS[w] for w in WRAPPERS}


def read(trace):
    return readers.roofline(
        trace, WRAPPERS, lambda op: readers.port_kernel(op)
        and readers.launched_under(op, OWNERS))
