"""The share of the attention core's calls that the fused kernel K9
took, as a ratio (1 when every call is fused): the port's counter
``attention.core.fused_calls`` over ``attention.core.calls``, both
totals of the process (the warm-up, the window and the traced cycles;
the judge's reference calls no code of the port). Read from a traced
train run; a program without those counters reads nothing."""

CALLS, FUSED = "attention.core.calls", "attention.core.fused_calls"


def read(run):
    if run.kind != "train" or run.out.get("trace") is None:
        return None
    from ctc_asr_tpu_torch.utils import profiling
    counts = profiling.counters() if hasattr(profiling, "counters") else {}
    if not counts.get(CALLS):
        run.log(f"attention_fused_share.train: the program counted no "
                f"{CALLS!r}")
        return None
    return counts.get(FUSED, 0) / counts[CALLS]
