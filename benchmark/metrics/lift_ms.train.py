"""The conv tier's lift (ops/groupconv.py's bf16 F.conv2d on cuDNN): device
ms of everything launched under the convolution and its weight gradient
(layout transforms and memsets included), per batch of 100 images."""

LIFT = {"aten::cudnn_convolution", "aten::convolution_backward"}


def read(trace):
    run = trace.run
    if run.kind != "train" or not run.images:
        return None
    ms = trace.seconds(lambda op: any(n in LIFT for n in op.chain)) * 1e3
    return ms / (run.images / 100.0) if ms > 0 else None
