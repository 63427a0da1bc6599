"""Idle ms a train step owes to its own launches: the window's idle gaps
ended by a launch under tvae.step (the forward's stages, the backward, Adam)
or by autograd's backward (benchmark/spans.py's charge), over the window's
steps. The host's Python between a step's launches, which the card waits
on."""

from benchmark import spans

read = spans.step_gap_ms
