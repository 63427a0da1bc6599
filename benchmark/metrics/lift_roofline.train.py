"""K13's share of its roofline in a train step (the conv tier's lift
forward, benchmark/lift.py)."""

from benchmark import lift


def read(trace):
    return lift.roofline(trace, "train")
