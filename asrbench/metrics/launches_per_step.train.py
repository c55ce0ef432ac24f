"""Device kernel launches a train step in the traced window (copies and
memsets not counted): a count, which the glue's merging lowers."""


def read(run):
    tr = run.out.get("trace")
    if run.kind != "train" or tr is None or not tr.kernels or not tr.steps:
        return None
    return len(tr.kernels) / tr.steps
