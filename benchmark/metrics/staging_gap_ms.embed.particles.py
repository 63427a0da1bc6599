"""staging_gap_ms.embed in the cells that embed particle stacks, which report
embed_img_s.particles: the same reading as metrics/staging_gap_ms.embed.py."""

from benchmark import spec

read = spec.metric_reader("staging_gap_ms.embed").read
