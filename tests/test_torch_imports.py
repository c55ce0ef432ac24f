"""The port stands on its own: no module of ``ctc_asr_tpu_torch`` and not
``chip_smoke`` imports ``jax`` or anything of the JAX package
``ctc_asr_tpu``. A subprocess installs an import hook that fails on
either, then imports every module of the port.
"""

import os
import pkgutil
import subprocess
import sys

import pytest

import ctc_asr_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the child imports the port: one thread, beside other test processes
_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}

_HOOK = '''
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "ctc_asr_tpu"):
            raise ImportError("the port must not import " + name)
        return None

sys.meta_path.insert(0, Refuse())
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ctc_asr_tpu"))
assert not bad, bad
print("imported", len(sys.argv) - 1)
'''


def _port_modules():
    names = ["ctc_asr_tpu_torch"]
    for m in pkgutil.walk_packages(ctc_asr_tpu_torch.__path__,
                                   "ctc_asr_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def test_walk_finds_the_whole_port():
    names = _port_modules()
    for expected in ("config", "text", "audio", "metrics", "cli", "train",
                     "evaluate", "transcribe", "data.loader", "data.synth",
                     "data.native_io", "data.feature_cache", "data.generate",
                     "utils.heartbeat", "utils.tb_events", "utils.profiling",
                     "ops.lm", "ops.beam", "ops.beam_cuda", "ops.gru_cuda",
                     "ops.build", "models.encoder", "models.rnn",
                     "parallel", "parallel.mesh", "parallel.dist",
                     "parallel.tp", "parallel.seqpar",
                     "parallel.decode_dist", "scripts",
                     "scripts.run_ladder_hard", "scripts.analyze_ladder",
                     "scripts.continue_rung", "scripts.run_oov",
                     "scripts.run_synth_ds2", "scripts.run_synth_ds3",
                     "scripts.run_synth_e2e", "scripts.run_synth_holdout",
                     "scripts.run_synth_lm",
                     "scripts.diag_oov_boundaries"):
        assert f"ctc_asr_tpu_torch.{expected}" in names


def test_no_module_imports_jax_or_the_jax_package():
    names = _port_modules() + ["chip_smoke"]
    proc = subprocess.run([sys.executable, "-c", _HOOK, *names], cwd=REPO,
                          capture_output=True, text=True, env=_ENV,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == f"imported {len(names)}"


def test_hook_catches_an_offender():
    """The hook itself works: importing the JAX package under it fails."""
    proc = subprocess.run([sys.executable, "-c", _HOOK, "ctc_asr_tpu.text"],
                          cwd=REPO, capture_output=True, text=True,
                          env=_ENV, timeout=300)
    assert proc.returncode != 0
    assert "must not import ctc_asr_tpu" in proc.stderr


@pytest.mark.parametrize("source", ["ctc_asr_tpu_torch", "chip_smoke.py"])
def test_no_source_line_names_the_jax_package_in_an_import(source):
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|ctc_asr_tpu)(\.|\s|$)")
    path = os.path.join(REPO, source)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
        if f.endswith(".py")]
    assert files
    for fn in files:
        with open(fn) as f:
            for i, line in enumerate(f, 1):
                assert not pat.match(line), f"{fn}:{i}: {line.strip()}"
