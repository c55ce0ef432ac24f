"""Device ms a train step in the port's ``rnn.recurrence`` ranges: each
layer's recurrence kernel (K2) and, through the backward node it
creates, its backward (K3 and the recurrent weights' gradient), summed
over the layers, over the steps of the trace. Read from the range, not
from the kernels' names."""

from asrbench.spans import device_ms

RANGE = "rnn.recurrence"


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "recurrence_ms.train", RANGE)
