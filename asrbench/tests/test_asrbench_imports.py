"""No process the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``ctc_asr_tpu_torch`` is not ``ctc_asr_tpu``), and
the reference loads nothing of the port either."""

import json
import os
import subprocess
import sys

from benchhelp import CELLS, ROOT

_ALL_DRIVERS = """
import json, sys
sys.path.insert(0, {root!r})
import contextlib, io
from asrbench import run, common
for cell in {cells!r}:
    with contextlib.redirect_stdout(io.StringIO()):
        assert run.main(["--workload", cell, "--seed", "3", "--seconds",
                         "0.2", "--trace", "0", "--tiny"]) == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import asrbench.reference.conv_bilstm, asrbench.reference.decode
import asrbench.reference.beam
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(src: str) -> set:
    out = subprocess.run([sys.executable, "-c", src.format(
        root=ROOT, cells=list(CELLS))], capture_output=True, text=True,
        cwd=ROOT, timeout=900, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_drivers_load_no_jax():
    names = _top_level(_ALL_DRIVERS)
    assert "ctc_asr_tpu_torch" in names           # the port was measured
    assert not names & {"jax", "jaxlib", "flax", "ctc_asr_tpu"}


def test_reference_loads_no_port():
    names = _top_level(_REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "ctc_asr_tpu",
                        "ctc_asr_tpu_torch"}
