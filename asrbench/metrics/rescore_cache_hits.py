"""The share of the word-LM rescoring's lookups that its cache answered,
in %: 100 x (1 - scored / lookups) from the port's counters
``lm.rescore.scored`` and ``lm.rescore.lookups``, over the whole
process (the warm-up cycle, the window and the traced cycles; the judge
rescores with the reference, not the port). Read from a traced run on
the card only, as the readers of ``asrbench/spans.py`` are."""

LOOKUPS, SCORED = "lm.rescore.lookups", "lm.rescore.scored"


def read(run):
    tr = run.out.get("trace")
    if run.kind != "decode" or tr is None or not tr.kernels:
        return None
    from ctc_asr_tpu_torch.utils import profiling
    counts = profiling.counters() if hasattr(profiling, "counters") else {}
    if not counts.get(LOOKUPS):
        run.log(f"rescore_cache_hits: the program counted no {LOOKUPS!r}")
        return None
    return 100.0 * (1.0 - counts.get(SCORED, 0) / counts[LOOKUPS])
