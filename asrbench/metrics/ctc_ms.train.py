"""Device ms a train step in the port's ``ctc.loss`` range: the
log-softmax, the label gather, the alpha DP (K6), the reduction and,
through their backward nodes, the beta DP (K7) and the gather's
backward, over the steps of the trace."""

from asrbench.spans import device_ms

RANGE = "ctc.loss"


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "ctc_ms.train", RANGE)
