"""The benchmark of ``ctc_asr_tpu_torch`` on one NVIDIA H100: cells named in
the repository's ``BENCHMARK.json``, each a configuration
(``configs/``), a traffic mix (``traffic/``) and a cell file
(``cells/``: its driver and the limits of its correctness check), run by
``python3 asrbench/run.py --workload <cell> --seed N --seconds S
--trace 0|1``. See ``README.md``."""
