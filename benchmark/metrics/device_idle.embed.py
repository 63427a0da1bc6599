"""Share of the traced embed window in which nothing ran on the card; in a
closed loop the host's part of each request lengthens every request."""

from benchmark import readers


def read(trace):
    return readers.idle_share(trace) if trace.run.kind == "embed" else None
