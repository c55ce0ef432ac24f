"""On the card (``python -m pytest asrbench/tests -m cuda`` on the chip):
a traced run of a train and a decode cell comes out correct and reads
every per-layer metric its cell lists, each share of a roofline or a
peak under 100%. Skips where there is no card."""

import json
import os
import subprocess
import sys

import pytest

from benchhelp import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ds2_train_b64", "ds2_decode_greedy_b128"])
def test_traced_cell_on_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "asrbench/run.py", "--workload", cell, "--seed",
         "2147483777", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        want = {m["name"] for m in json.load(f)["per_layer"]
                if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] < 100, (name, m)
