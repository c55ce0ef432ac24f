"""The port's experiment runners, counterparts of the repo's ``scripts/``.

``run_ladder_hard`` trains and evaluates the configuration ladder on the
hard synthetic corpus, ``analyze_ladder`` tabulates its records and ranks
the best rungs by the paired bootstrap, and ``continue_rung`` resumes one
rung to a larger step budget. ``run_oov`` decodes the r4big arms on the
n=4096 settler split and the open-vocabulary splits. ``run_synth_e2e``,
``run_synth_ds2``, ``run_synth_lm``, ``run_synth_ds3`` and
``run_synth_holdout`` are the round-1 runs on the simple synthetic
corpus. ``diag_oov_boundaries`` decodes a split with a checkpoint and
writes the hypotheses, the word boundaries they insert or drop and the
greedy path's blank and space posteriors, reference word by reference
word. Each runs as a module, e.g.
``python -m ctc_asr_tpu_torch.scripts.run_ladder_hard --out /tmp/ladder``.
"""
