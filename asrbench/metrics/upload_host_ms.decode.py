"""Host ms a decode batch in the port's ``train.upload`` range: the
batch's host arrays wrapped, pinned and their copies to the card
enqueued, over the batches of the trace."""

from asrbench.spans import host_ms

RANGE = "train.upload"


def read(run):
    if run.kind != "decode":
        return None
    return host_ms(run, "upload_host_ms.decode", RANGE)
