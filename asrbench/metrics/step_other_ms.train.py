"""Device ms a train step in the port's ``train.step`` range outside
every layer range inside it (features, frontend, RNN layers, CTC loss,
Adam): the step's own kernels (the head, the masks, transposes, casts,
the gradient's plumbing), over the steps of the trace."""

from asrbench.spans import device_ms

RANGE = "train.step"
LAYERS = ("features.extract", "encoder.frontend", "encoder.rnn", "ctc.loss",
          "optim.adam")


def read(run):
    if run.kind != "train":
        return None
    return device_ms(run, "step_other_ms.train", RANGE, minus=LAYERS)
