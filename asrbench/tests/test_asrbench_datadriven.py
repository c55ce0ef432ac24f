"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files and entries, and edits no file the benchmark
has: the harness finds each by its name."""

import json
import os
import shutil

from benchhelp import ROOT, checkout, run_in

METRIC = '''"""Mean unpadded audio seconds a window step."""


def read(run):
    recs = run.out["records"]
    if run.kind != "train" or not recs:
        return None
    return sum(float(r["lengths"].sum()) for r in recs) / len(recs) / 16000
'''


def test_new_files_found_by_name(tmp_path):
    root = checkout(tmp_path)
    ab = root / "asrbench"
    cfg = json.loads((ab / "configs" / "ds2.json").read_text())
    cfg["config"]["model"]["rnn_layers"] = 2
    (ab / "configs" / "ds2_two.json").write_text(json.dumps(cfg))
    mix = json.loads((ab / "traffic" / "libri_test_b128.json").read_text())
    mix.update(batch_size=8, num_buckets=4)
    (ab / "traffic" / "short_b8.json").write_text(json.dumps(mix))
    (ab / "metrics" / "audio_per_step.train.py").write_text(METRIC)
    (ab / "cells" / "ds2two_train_short.json").write_text(json.dumps(
        {"driver": "train", "limits": {"loss_gap": 0.01, "grad_gap": 0.05,
                                       "change_gap": 0.1}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ds2_two", "source": "x",
                             "file": "asrbench/configs/ds2_two.json",
                             "reduced": ["rnn_layers"], "why": "x"})
    bench["workloads"].append({"name": "ds2two_train_short",
                               "config": "ds2_two", "traffic": "short_b8",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("ds2two_train_short")
    bench["per_layer"].append({"name": "audio_per_step.train", "unit": "s",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step",
                               "moves": "train_audio_s_per_s",
                               "workloads": ["ds2two_train_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_in(root, "run.py", "--workload", "ds2two_train_short", "--seed",
                 "9", "--seconds", "0.3", "--trace", "1", "--tiny")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["audio_per_step.train"]["value"] > 0
    assert line["metrics"]["audio_per_step.train"]["unit"] == "s"


def _run(cwd, *extra):
    return run_in(cwd, "run.py", "--workload", "ds2_train_b64", "--seed", "1",
                  "--seconds", "1", "--trace", "0", *extra)


def test_no_card_no_result():
    """Without a card (and without --tiny) a run fails and prints nothing."""
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to measure: the run fails and prints no result."""
    shutil.copytree(os.path.join(ROOT, "asrbench"), tmp_path / "asrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path, "--tiny")
    assert out.returncode != 0 and out.stdout.strip() == ""
