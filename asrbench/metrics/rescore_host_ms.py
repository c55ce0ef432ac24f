"""Host ms a batch in ``pick_best`` (the word-LM rescoring of each row's
N-best, its texts and the copy of the N-best to the host), timed by the
benchmark around the call after the device has finished the batch:
the mean over the untraced window's batches."""


def read(run):
    ms = run.out.get("rescore_ms")
    if run.kind != "decode" or not ms or not any(ms):
        return None
    return sum(ms) / len(ms)
