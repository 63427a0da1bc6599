"""Idle ms per 100 images an embed owes to its staging: the window's idle
gaps ended by a launch under tvae.embed.stage (the wait on a pinned
buffer's last copy, the host's fill of it, the copy's launch), per 100
images embedded (benchmark/spans.py's charge)."""

from benchmark import spans

read = spans.staging_gap_ms
