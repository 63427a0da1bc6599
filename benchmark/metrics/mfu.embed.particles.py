"""mfu.embed in the cells that embed particle stacks, which report
embed_img_s.particles: the same reading as metrics/mfu.embed.py."""

from benchmark import spec

read = spec.metric_reader("mfu.embed").read
