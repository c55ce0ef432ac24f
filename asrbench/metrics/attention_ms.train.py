"""Device ms a train step in the port's ``conformer.attention`` range:
every conformer block's self-attention (LayerNorm, the q / k / v /
position projections, the core of scores, shift, mask, softmax and
weighted sum, the output linear), forward and backward, over the steps
of the trace."""

from asrbench.spans import device_ms

RANGE = "conformer.attention"


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "attention_ms.train", RANGE)
