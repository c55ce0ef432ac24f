"""The whole train step's share of the chip's bf16 peak: the algorithmic
FLOPs of every window step (the run's family's ``step_flops`` on each
row's unpadded length, forward x 3) over the untraced window's wall time at
989 TFLOP/s, in %. Padding is waste here, as in the rate it moves."""

from asrbench.flops import window_mfu


def read(run):
    if run.kind != "train" or not run.out["records"]:
        return None
    return window_mfu(run.family, run.out["records"], run.cfg,
                      run.out["window_s"], run.sample_rate, fwd_only=False)
