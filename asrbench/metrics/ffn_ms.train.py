"""Device ms a train step in the port's ``conformer.ffn`` range: both feed-
forward halves of every conformer block (LayerNorm, Linear, Swish,
Linear), forward and backward, over the steps of the trace."""

from asrbench.spans import device_ms

RANGE = "conformer.ffn"


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "ffn_ms.train", RANGE)
