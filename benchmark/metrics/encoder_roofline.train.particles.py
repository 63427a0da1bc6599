"""encoder_roofline.train in the cells that train on particle stacks, which report
train_img_s.particles: the same reading as metrics/encoder_roofline.train.py."""

from benchmark import spec

read = spec.metric_reader("encoder_roofline.train").read
