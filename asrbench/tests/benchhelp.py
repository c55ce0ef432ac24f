"""Helpers of the benchmark's tests."""

import json
import os
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

