"""The conv frontend's share of its roofline in training, in %: the least
time of its forward and backward on each traced step's padded feature
shape (``flops.frontend_bound``: the true 2-D convs' FLOPs at the bf16
peak, or their bytes) over the device time of the kernels launched in
the port's ``encoder.frontend`` range or in the backward of the
autograd nodes it created."""

from asrbench import flops
from asrbench.trace import kernels_in_range

RANGE = "encoder.frontend"


def read(run):
    tr = run.out.get("trace")
    if run.kind != "train" or tr is None or not tr.records:
        return None
    ks = kernels_in_range(tr, RANGE)
    if not ks:
        run.log(f"frontend_conv_roofline.train: the work was done but no "
                f"kernel of the {RANGE!r} range was found")
        return None
    bound = sum(flops.frontend_bound(
        run.cfg, r["B"], flops.num_frames(r["S"], run.cfg["features"])
        )["bound_ms"] for r in tr.records)
    return 100.0 * bound / (sum(e - s for _, s, e, _ in ks) / 1e3)
