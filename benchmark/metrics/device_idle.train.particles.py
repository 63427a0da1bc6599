"""device_idle.train in the cells that train on particle stacks, which report
train_img_s.particles: the same reading as metrics/device_idle.train.py."""

from benchmark import spec

read = spec.metric_reader("device_idle.train").read
