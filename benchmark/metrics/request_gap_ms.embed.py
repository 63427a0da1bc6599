"""Idle ms between two embed requests: a gap after a request's copy to the
host (launched under tvae.embed.out) up to the next request's first launch,
the mean over the window's (benchmark/spans.py's charge). In a closed loop
each request pays it once."""

from benchmark import spans

read = spans.request_gap_ms
