"""Helpers of the benchmark's tests."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("ds3_train_b64", "ds3_decode_fusion_b128", "ds2_train_b64",
         "ds2_decode_greedy_b128")
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(capsys, *argv) -> dict:
    """``run.py --tiny`` in this process; its last stdout line as JSON."""
    from asrbench import run
    capsys.readouterr()
    rc = run.main([*argv, "--tiny"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out[-5:]
    return json.loads(out[-1])



def checkout(tmp_path):
    """A checkout of the benchmark beside the port, to add files to:
    ``asrbench/`` without its tests, ``BENCHMARK.json``, and the port
    linked in."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "asrbench"), root / "asrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "ctc_asr_tpu_torch"),
               root / "ctc_asr_tpu_torch")
    return root


def run_in(root, script, *argv, env=None):
    """``python3 asrbench/<script> *argv`` in the checkout ``root``, torch
    on one thread."""
    return subprocess.run(
        [sys.executable, f"asrbench/{script}", *argv], cwd=root,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})})
