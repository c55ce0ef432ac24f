"""Host ms a decode batch in the port's ``evaluate.nbest_texts`` range:
the text of each of the batch's B x N hypotheses, before the word-LM
rescoring, over the batches of the trace."""

from asrbench.spans import host_ms

RANGE = "evaluate.nbest_texts"


def read(run):
    if run.kind != "decode":
        return None
    return host_ms(run, "nbest_texts_ms", RANGE)
