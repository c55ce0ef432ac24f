"""Device ms a train step in the port's ``encoder.rnn`` ranges outside
their ``rnn.recurrence``: each RNN layer's input projections, direction
stacks, flips and concatenation, casts and dropout, forward and
backward, over the steps of the trace."""

from asrbench.spans import device_ms

RANGE, INNER = "encoder.rnn", "rnn.recurrence"


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "rnn_other_ms.train", RANGE, minus=(INNER,))
