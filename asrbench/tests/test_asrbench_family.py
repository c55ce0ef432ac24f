"""A configuration names its model family (``"family"``, a module
``asrbench/reference/<family>.py``; ``conv_bilstm`` where it names none),
and the harness reaches the model only through it:

(a) the conv_bilstm family gives the values the harness gave before the
    family was a lookup (the digests and checks below were read from that
    tree);
(b) a family named in a configuration is the one that runs: a test-only
    family that wraps conv_bilstm and counts its calls sees every hook;
(c) each cell is listed under every end-to-end metric its driver reports;
(d) an unknown family, or a decode cell's family without
    ``shape_for_decode``, stops the run at load.
"""

import hashlib
import importlib
import json
import os
import time

import pytest

from benchhelp import CELLS, ROOT, checkout, run_in

SEED = 2**31 + 41
# sha256 over (key, shape, f32 bytes) of every leaf of make_params at the
# tiny cut and SEED; and over the shapes at the configurations' own sizes
PARAMS_SHA = "30889935f7153c88682614883226fb67190392b0b4975a95a5b740c0e3a8bb9e"
SHAPES_SHA = {
    "ds3": "7c07ea1e441f70bd2506a03cb526e9ed53b83bc9a0579f39581a37e1543901e4",
    "ds2": "3f121900bbbb909675012f139db78bac510301c3d4950cae13cdbb7757fff0c0"}
# the checks of `run.py --tiny --seed SEED --seconds 0.3 --trace 0`
CHECKS = {
    "ds3_train_b64": {"loss_gap": 5.4055843802575253e-05,
                      "grad_gap": 0.003369808327046523,
                      "change_gap": 0.004309506458294231},
    "ds3_decode_fusion_b128": {"frame_gap": 0.004372596740722656,
                               "dist_gap": 0.03679928183555603,
                               "answer_gap": 0.0},
    "ds2_train_b64": {"loss_gap": 5.4055843802575253e-05,
                      "grad_gap": 0.003369808327046523,
                      "change_gap": 0.004309506458294231},
    "ds2_decode_greedy_b128": {"frame_gap": 0.004372596740722656,
                               "dist_gap": 0.03679928183555603,
                               "answer_gap": 5.7220458984375e-06}}


def _ctx(cell, tiny=True):
    from asrbench import common
    return common.load_ctx(cell, SEED, 0.3, False, tiny, time.perf_counter())


@pytest.mark.parametrize("config,cell", [("ds3", "ds3_train_b64"),
                                         ("ds2", "ds2_train_b64")])
def test_params_equal_the_parents(config, cell):
    from asrbench import weights
    ctx = _ctx(cell)
    assert ctx.family.__name__ == "asrbench.reference.conv_bilstm"
    h = hashlib.sha256()
    for k, v in weights.make_params(ctx.family, ctx.cfg, SEED, "cpu").items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == PARAMS_SHA
    full = _ctx(cell, tiny=False)
    shapes = list(full.family.param_shapes(full.cfg).items())
    assert hashlib.sha256(json.dumps(shapes).encode()).hexdigest() == \
        SHAPES_SHA[config]


@pytest.mark.parametrize("cell", CELLS)
def test_checks_equal_the_parents(tiny, cell):
    line = tiny("--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                "--trace", "0")
    assert {k: c["value"] for k, c in line["checks"].items()} == CHECKS[cell]


COUNTED = '''"""conv_bilstm under another name, one layer deep at --tiny, counting
the harness's calls of each function, and the operands the control
rounds, into the file named by ASRBENCH_COUNTS."""
import atexit
import json
import os

from asrbench.reference import conv_bilstm as base

TINY_CONFIG = {**base.TINY_CONFIG,
               "model": {**base.TINY_CONFIG["model"], "rnn_layers": 1}}
COUNTS = {"layers": []}


def _counted(name, fn):
    def call(*args, **kw):
        COUNTS[name] = COUNTS.get(name, 0) + 1
        return fn(*args, **kw)
    return call


for _name in ("init_fixed", "train_steps", "log_probs", "logits",
              "step_flops", "encoder_frames", "shape_for_decode"):
    globals()[_name] = _counted(_name, getattr(base, _name))


def param_shapes(cfg):
    COUNTS["layers"].append(cfg["model"]["rnn_layers"])
    return _counted("param_shapes", base.param_shapes)(cfg)


_round = base.quantize


def quantize(x, quant):
    if quant is not None:
        COUNTS[f"quantize:{quant}"] = COUNTS.get(f"quantize:{quant}", 0) + 1
    return _round(x, quant)


base.quantize = quantize        # the reference's own operands pass here


def _write():
    with open(os.environ["ASRBENCH_COUNTS"], "w") as f:
        json.dump(COUNTS, f)


atexit.register(_write)
'''

FRAMES = '''"""Encoder frames of the window's rows, by the run's family."""


def read(run):
    return float(sum(run.family.encoder_frames(int(n), run.cfg)
                     for r in run.out["records"] for n in r["lengths"]))
'''


def _add_cells(root, family_source, family, cells):
    """``family_source`` as ``reference/<family>.py``, a copy of ds2 that
    names it, and ``cells`` ({name: (driver, traffic)}) of that copy,
    listed under their driver's end-to-end metrics."""
    ab = root / "asrbench"
    if family_source is not None:
        (ab / "reference" / f"{family}.py").write_text(family_source)
    cfg = json.loads((ab / "configs" / "ds2.json").read_text())
    cfg["family"] = family
    (ab / "configs" / f"ds2_{family}.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": f"ds2_{family}", "source": "x",
                             "file": f"asrbench/configs/ds2_{family}.json",
                             "reduced": [], "why": "x"})
    kinds = {"train": "ds2_train_b64", "decode": "ds2_decode_greedy_b128"}
    for name, (driver, traffic) in cells.items():
        (ab / "cells" / f"{name}.json").write_text(
            (ab / "cells" / f"{kinds[driver]}.json").read_text())
        bench["workloads"].append({"name": name, "config": f"ds2_{family}",
                                   "traffic": traffic, "chips": 1,
                                   "why": "x"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if kinds[driver] in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def test_named_family_is_the_one_that_runs(tmp_path):
    from asrbench import common
    root = checkout(tmp_path)
    cells = {"counted_train": ("train", "libri_train_b64"),
             "counted_decode": ("decode", "libri_test_b128")}
    bench = _add_cells(root, COUNTED, "counted", cells)
    (root / "asrbench" / "metrics" / "frames.py").write_text(FRAMES)
    bench["per_layer"].append({"name": "frames", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "setup_s",
                               "workloads": list(cells)})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    counts = {}
    for cell in cells:
        for script, argv in (
                ("run.py", ["--seed", "9", "--seconds", "0.3", "--trace",
                            "1"]),
                ("controls.py", ["--seeds", "1", "--control"])):
            path = tmp_path / f"{cell}.{script}.json"
            out = run_in(root, script, "--workload", cell, *argv, "--tiny",
                         env={"ASRBENCH_COUNTS": str(path)})
            assert out.returncode == 0, out.stderr[-3000:]
            line = json.loads(out.stdout.strip().splitlines()[-1])
            if script == "run.py":
                assert line["correct"] is True
                assert line["metrics"]["frames"]["value"] > 0
            counts[cell, script] = json.loads(path.read_text())
    for got in counts.values():
        assert set(got.pop("layers")) == {1}     # the family's tiny cut
    assert {"param_shapes", "init_fixed", "train_steps", "step_flops",
            "encoder_frames"} <= set(counts["counted_train", "run.py"])
    assert {"param_shapes", "init_fixed", "shape_for_decode", "logits",
            "log_probs", "step_flops", "encoder_frames"} <= \
        set(counts["counted_decode", "run.py"])
    assert {"train_steps", "quantize:fp8"} <= \
        set(counts["counted_train", "controls.py"])
    assert {"log_probs", "quantize:fp8"} <= \
        set(counts["counted_decode", "controls.py"])
    called = {k for got in counts.values() for k in got} - {"quantize:fp8"}
    assert called == (set(common.CONTRACT) - {"TINY_CONFIG"}) | {
        common.DECODE_HOOK}


def test_each_cell_listed_where_it_reports():
    import torch
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= names, m["name"]
    torch.set_num_threads(1)
    for cell in sorted(names):
        ctx = _ctx(cell)
        driver = importlib.import_module(
            f"asrbench.drivers.{ctx.cell_file['driver']}")
        reported = set(driver.run(ctx)["e2e"])
        listed = {m["name"] for m in bench["end_to_end"]
                  if cell in m.get("workloads", [cell])}
        assert listed == reported, cell


NO_HOOK = '''"""conv_bilstm without the decode cells' hook."""
from asrbench.reference.conv_bilstm import *  # noqa: F401,F403

del shape_for_decode  # noqa: F821
'''


@pytest.mark.parametrize("family,driver,says", [
    ("nosuch", "train", "names no module"),
    ("nohook", "decode", "lacks ['shape_for_decode']")])
def test_bad_family_fails_at_load(tmp_path, family, driver, says):
    root = checkout(tmp_path)
    traffic = {"train": "libri_train_b64", "decode": "libri_test_b128"}
    _add_cells(root, {"nohook": NO_HOOK}.get(family), family,
               {"bad": (driver, traffic[driver])})
    out = run_in(root, "run.py", "--workload", "bad", "--seed", "1",
                 "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert f'asrbench/configs/ds2_{family}.json: "family": {family!r}' \
        in out.stderr and says in out.stderr
    assert "CUDA" not in out.stderr              # before any card work
