"""The port's experiment runners, counterparts of the repo's ``scripts/``.

``run_ladder_hard`` trains and evaluates the configuration ladder on the
hard synthetic corpus, ``analyze_ladder`` tabulates its records and ranks
the best rungs by the paired bootstrap, and ``continue_rung`` resumes one
rung to a larger step budget. Each runs as a module, e.g.
``python -m ctc_asr_tpu_torch.scripts.run_ladder_hard --out /tmp/ladder``.
"""
