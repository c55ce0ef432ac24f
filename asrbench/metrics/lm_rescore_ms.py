"""Host ms a decode batch in the port's ``lm.rescore`` range: the
word-LM scoring of each hypothesis missing from the cache, the cache's
lookups and the choice of each row's best, over the batches of the
trace."""

from asrbench.spans import host_ms

RANGE = "lm.rescore"


def read(run):
    if run.kind != "decode":
        return None
    return host_ms(run, "lm_rescore_ms", RANGE)
