"""The Conformer's attention core's share of its roofline in training, in
%: the least time of its forward and backward on each traced step's rows
at their unpadded lengths (the family's ``attention_work``: FLOPs at
989 TFLOP/s or bytes at 3.35 TB/s, whichever is longer) over the device
time of the kernels launched in the port's ``attention.core`` range or
in the backward of the autograd nodes it created. The padded work the
program does besides is waste here."""

from asrbench import flops
from asrbench.trace import kernels_in_range

RANGE = "attention.core"


def read(run):
    tr = run.out.get("trace")
    if run.kind != "train" or tr is None or not tr.records \
            or not tr.kernels:
        return None
    work = getattr(run.family, "attention_work", None)
    if work is None:
        run.log("attention_roofline.train: the model's family counts no "
                "attention work")
        return None
    ks = kernels_in_range(tr, RANGE)
    if not ks:
        run.log(f"attention_roofline.train: the trace holds no kernel of "
                f"the {RANGE!r} range")
        return None
    bound = 0.0
    for r in tr.records:
        w = work(run.cfg, [run.family.encoder_frames(int(n), run.cfg)
                           for n in r["lengths"]])
        bound += flops.bound(w["bytes"], w["flops"],
                             flops.PEAK_BF16)["bound_ms"]
    return 100.0 * bound / (sum(e - s for _, s, e, _ in ks) / 1e3)
