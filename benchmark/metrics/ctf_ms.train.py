"""The CTF of the Gaussian likelihood (losses/likelihoods.py::ctf_apply):
device ms a step of the FFTs, forward and backward (every operation
launched under an FFT op or its autograd node), and of the spectra's
complex products (kernels on complex numbers)."""

import re

FFT = re.compile(r"fft", re.IGNORECASE)


def _ctf(op):
    return "complex" in op.name or any(FFT.search(n) for n in op.chain)


def read(trace):
    run = trace.run
    if run.kind != "train" or not run.steps:
        return None
    ms = trace.seconds(_ctf) * 1e3
    return ms / run.steps if ms > 0 else None
