"""device_idle.embed in the cells that embed particle stacks, which report
embed_img_s.particles: the same reading as metrics/device_idle.embed.py."""

from benchmark import spec

read = spec.metric_reader("device_idle.embed").read
