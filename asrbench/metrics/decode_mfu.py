"""The whole decode path's share of the chip's bf16 peak: the forward's
algorithmic FLOPs (the run's family's ``step_flops`` / 3 on each row's
unpadded length) of every window batch over the untraced window's wall
time at 989 TFLOP/s, in %."""

from asrbench.flops import window_mfu


def read(run):
    if run.kind != "decode" or not run.out["records"]:
        return None
    return window_mfu(run.family, run.out["records"], run.cfg,
                      run.out["window_s"], run.sample_rate, fwd_only=True)
