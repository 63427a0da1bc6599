"""step_gap_ms.train in the cells that train on particle stacks, which report
train_img_s.particles: the same reading as metrics/step_gap_ms.train.py."""

from benchmark import spec

read = spec.metric_reader("step_gap_ms.train").read
