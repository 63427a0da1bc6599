"""The patch tier's im2col (models/encoders.py: the pad and
kernels/lifted_encoder.py::build_patches' copy) in an embed: device ms of
everything launched under tvae.patches, per batch of 100 images."""

from benchmark import spans


def read(trace):
    return spans.device_ms_under(trace, "tvae.patches", "embed")
