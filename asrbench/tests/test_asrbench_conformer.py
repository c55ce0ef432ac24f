"""The ``conformer`` family and its cells: the family keeps the contract
and loads nothing of the port; its FLOPs a step and the attention core's
work equal a hand count at two shapes; each new reader reads a number on
a hand-made trace and None where its range or counter is missing; the
new cell runs ``--tiny`` to a ``correct`` line."""

import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from benchhelp import ROOT
from asrbench import common, flops
from asrbench.reference import conformer
from asrbench.trace import TraceData

NEW_CELLS = ("conformer_large_train_b64",)


def _cfg(tiny=False):
    with open(os.path.join(ROOT, "asrbench", "configs",
                           "conformer_large.json")) as f:
        cfg = json.load(f)["config"]
    return common._merge(cfg, conformer.TINY_CONFIG) if tiny else cfg


def test_family_keeps_the_contract():
    path = "asrbench/configs/conformer_large.json"
    with open(os.path.join(ROOT, path)) as f:
        config_file = json.load(f)
    family = common.load_family(config_file, path, "train")
    assert family is conformer
    shapes = conformer.param_shapes(_cfg())
    # NeMo's Large row: 6.32 M a layer, 7.6 M of subsampling, the head
    assert sum(math.prod(s) for s in shapes.values()) == 121_450_013
    assert list(shapes)[-2:] == ["head/w", "head/b"]
    assert shapes["head/w"] == (512, 29)
    fixed = {k: conformer.init_fixed(k, s, _cfg(), "cpu")
             for k, s in shapes.items()}
    assert fixed["layers/0/att/pos_u"].abs().sum() == 0
    assert fixed["layers/0/conv/bn/scale"].sum() == 512
    assert fixed["layers/0/att/q/w"] is None
    src = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
           "import asrbench.reference.conformer; "
           "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "ctc_asr_tpu",
                        "ctc_asr_tpu_torch"}


# hand counts (the arithmetic written out in the comments)
@pytest.mark.parametrize("tiny,rows,seconds,want", [
    # 1 s: 98 frames -> 49 -> 25; 80 bins -> 40 -> 20. conv0 2*49*40*512*9
    # = 18,063,360; conv1 2*25*20*512*9*512 = 2,359,296,000; linear
    # 2*25*10240*512 = 262,144,000; a layer: FFNs 209,715,200, q/k/v/o
    # 52,428,800, positions 2*49*512^2 = 25,690,112, scores 3*2*25^2*512 =
    # 1,920,000, pointwise 26,214,400 + 13,107,200, depthwise 793,600 =
    # 329,869,312, x 18; head 742,400: forward 8,577,893,376, x 3
    (False, 1, 1.0, 25_733_680_128),
    # tiny, 0.75 s: 73 -> 37 -> 19 frames; conv0 106,560, conv1 109,440,
    # linear 48,640, a layer 280,384 x 2, head 17,632: 843,040 x 3 x 2 rows
    (True, 2, 0.75, 5_058_240),
])
def test_step_flops_hand_count(tiny, rows, seconds, want):
    assert conformer.step_flops(_cfg(tiny), rows, seconds) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("tiny,frames,want_flops,want_bytes", [
    # 18 layers, d 512: 18 * 512 * (25^2 + 19^2) * 18; bytes 18 * 2 * 512
    # * ((4*44 + 49 + 44) + (5*44 + 49) + (4*44 + 49))
    (False, [25, 19], 163_565_568, 14_063_616),
    # 2 layers, d 16: 18 * 16 * 100 * 2; 2 * 2 * 16 * (69 + 69 + 59)
    (True, [10], 57_600, 12_608),
])
def test_attention_work_hand_count(tiny, frames, want_flops, want_bytes):
    w = conformer.attention_work(_cfg(tiny), frames)
    assert w["flops"] == want_flops and w["bytes"] == want_bytes
    assert conformer.attention_work(_cfg(tiny), []) == {"flops": 0.0,
                                                         "bytes": 0.0}


def test_encoder_frames():
    cfg = _cfg()
    assert conformer.encoder_frames(16000, cfg) == 25
    assert conformer.encoder_frames(270080, cfg) == 422   # the longest


SPANS = {"subsampling_ms.train": ("conformer.subsampling", 2.0, 3.0),
         "ffn_ms.train": ("conformer.ffn", 1.0, 2.5),
         "attention_ms.train": ("conformer.attention", 0.5, 0.5),
         "conv_module_ms.train": ("conformer.conv_module", 1.5, 1.0)}
CORE = (0.75, 1.25)              # attention.core inside conformer.attention
STEPS = 2
ROWS = [16000, 12000]            # 25 and 19 encoder frames


def _trace(ranges=True) -> TraceData:
    """Two steps; each range launches one forward kernel from its own op
    and one backward kernel from that op's backward node (tied by the
    sequence number); attention.core nests in conformer.attention."""
    cpu, kernels = [], []
    state = {"id": 1000, "dev": 0.0}

    def event(name, s, e, thread=1, seq=-1):
        state["id"] += 1
        cpu.append((name, s, e, thread, seq, state["id"]))

    def launch(t, thread, ms):
        state["id"] += 1
        cpu.append(("cudaLaunchKernel", t, t + 1, thread, -1, state["id"]))
        kernels.append((f"k{state['id']}", state["dev"],
                        state["dev"] + ms * 1e3, state["id"]))
        state["dev"] += ms * 1e3 + 1

    seq = 0
    for step in range(STEPS):
        t0 = step * 100_000
        back = t0 + 50_000
        items = list(SPANS.values()) + [("attention.core", *CORE)]
        for i, (name, fwd, bwd) in enumerate(items):
            s = t0 + 1_000 * (i + 1)
            if name == "attention.core":      # inside the attention range
                s = t0 + 3_000 + 100
            e = s + (800 if name != "attention.core" else 300)
            if ranges:
                event(name, s, e)
            seq += 1
            event(f"aten::op{seq}", s + 20, s + 60, seq=seq)
            launch(s + 30, 1, fwd)
            event(f"Op{seq}Backward0", back, back + 100, thread=2, seq=seq)
            launch(back + 10, 2, bwd)
            back += 200
    records = [{"bucket": 0, "B": 2, "S": 16000, "U": 16,
                "lengths": np.asarray(ROWS)}] * STEPS
    return TraceData(kernels, [], cpu, (0.0, state["dev"]), steps=STEPS,
                     records=records)


def _run(trace, logs=None):
    return SimpleNamespace(kind="train", out={"trace": trace}, cfg=_cfg(),
                           family=conformer, sample_rate=16000,
                           log=(logs.append if logs is not None
                                else lambda m: None))


def _read(metric, run_):
    from asrbench import run
    return run._reader(os.path.join(ROOT, "asrbench", "metrics",
                                    metric + ".py")).read(run_)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_readers(metric):
    _, fwd, bwd = SPANS[metric]
    want = fwd + bwd + (sum(CORE) if metric == "attention_ms.train" else 0)
    assert _read(metric, _run(_trace())) == pytest.approx(want)
    logs = []
    assert _read(metric, _run(_trace(ranges=False), logs)) is None
    assert logs and "no" in logs[0]


def test_attention_roofline_reader():
    frames = [conformer.encoder_frames(n, _cfg()) for n in ROWS]
    w = conformer.attention_work(_cfg(), frames)
    bound = flops.bound(w["bytes"], w["flops"], flops.PEAK_BF16)["bound_ms"]
    want = 100.0 * STEPS * bound / (STEPS * sum(CORE))
    assert _read("attention_roofline.train", _run(_trace())) == \
        pytest.approx(want)
    logs = []
    assert _read("attention_roofline.train",
                 _run(_trace(ranges=False), logs)) is None
    assert logs
    no_family = _run(_trace())
    no_family.family = SimpleNamespace(encoder_frames=conformer.encoder_frames)
    assert _read("attention_roofline.train", no_family) is None


@pytest.mark.parametrize("ranges", [True, False])
def test_attention_pad_share_reader(ranges):
    """Each traced step pads its rows (25 and 19 encoder frames) to the
    batch's 25: 1 - (25^2 + 19^2) / (2 x 25^2); nothing without the
    attention core's range."""
    logs = []
    got = _read("attention_pad_share.train", _run(_trace(ranges), logs))
    if ranges:
        assert got == pytest.approx(100.0 * (1 - (25**2 + 19**2)
                                             / (2 * 25**2)))
    else:
        assert got is None and logs


@pytest.mark.parametrize("cell", NEW_CELLS)
def test_new_cell_runs_tiny(tiny, cell):
    line = tiny("--workload", cell, "--seed", str(2**31 + 23),
                "--seconds", "0.3", "--trace", "0")
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"train_audio_s_per_s", "setup_s"}


@pytest.mark.cuda
def test_traced_conformer_cell_on_card():
    """On the card: a traced run of the cell is correct and reads every
    per-layer metric the cell lists, each share under 100%."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = NEW_CELLS[0]
    out = subprocess.run(
        [sys.executable, "asrbench/run.py", "--workload", cell, "--seed",
         "2147483779", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        want = {m["name"] for m in json.load(f)["per_layer"]
                if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] < 100, (name, m)
