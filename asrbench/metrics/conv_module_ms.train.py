"""Device ms a train step in the port's ``conformer.conv_module`` range:
every conformer block's conv module (LayerNorm, pointwise conv, GLU,
masking, depthwise conv, BatchNorm, Swish, pointwise conv), forward and
backward, over the steps of the trace."""

from asrbench.spans import device_ms

RANGE = "conformer.conv_module"


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "conv_module_ms.train", RANGE)
