"""Device ms a train step in the port's ``conformer.subsampling`` range:
the striding-conv subsampling (two 3x3 stride-2 convs, their ReLUs, the
frame linear and the x-scaling), forward and, through their backward
nodes, backward, over the steps of the trace."""

from asrbench.spans import device_ms

RANGE = "conformer.subsampling"


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "subsampling_ms.train", RANGE)
