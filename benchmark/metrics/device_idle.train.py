"""Share of the traced train window in which nothing ran on the card (1
minus the union of the kernels', copies' and memsets' intervals)."""

from benchmark import readers


def read(trace):
    return readers.idle_share(trace) if trace.run.kind == "train" else None
