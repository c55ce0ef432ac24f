"""Device ms a train step in the port's ``optim.adam`` range: the global
norm, the clip and every leaf's Adam update, over the steps of the
trace."""

from asrbench.spans import device_ms

RANGE = "optim.adam"


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "adam_ms.train", RANGE)
