"""encoder_roofline.embed in the cells that embed particle stacks, which report
embed_img_s.particles: the same reading as metrics/encoder_roofline.embed.py."""

from benchmark import spec

read = spec.metric_reader("encoder_roofline.embed").read
