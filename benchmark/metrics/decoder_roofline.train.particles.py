"""decoder_roofline.train in the cells that train on particle stacks, which report
train_img_s.particles: the same reading as metrics/decoder_roofline.train.py."""

from benchmark import spec

read = spec.metric_reader("decoder_roofline.train").read
