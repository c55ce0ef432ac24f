"""The readers of the port's spans and counters (``asrbench/spans.py`` and
the metrics that use it): on a hand-made trace of two steps with known
kernels, host ranges nested in one another and backward nodes tied to
their forward by sequence number, each reader returns the expected ms;
on a traced tiny CPU run each returns a value or None and never
raises."""

import importlib
import os
import time
from types import SimpleNamespace

import pytest

from benchhelp import ROOT
from asrbench.trace import TraceData

STEPS = 2
# per step, each range inside train.step and rnn.recurrence inside
# encoder.rnn: (host range, [(seq nr of a forward op, forward kernel ms,
# backward kernel ms)], kernel ms launched with no op)
LAYOUT = [
    ("features.extract", [], 1.0),
    ("encoder.frontend", [(1, 2.0, 3.0)], 0.0),
    ("encoder.rnn", [(2, 0.5, 0.7)], 0.0),
    ("rnn.recurrence", [(3, 4.0, 6.0)], 0.0),
    ("ctc.loss", [(4, 0.3, 0.4)], 0.0),
    ("optim.adam", [], 1.5),
]
STEP_SELF_MS = 0.25     # launched in train.step outside every layer range
HOST_MS = {"train.upload": 1.5, "evaluate.nbest_texts": 9.0,
           "lm.rescore": 21.0}


class _Events:
    def __init__(self):
        self.cpu, self.kernels, self.next_id = [], [], 1000
        self.t_dev = 0.0

    def launch(self, t: float, thread: int, ms: float) -> None:
        """A launch on the host at ``t`` and its kernel of ``ms``."""
        self.next_id += 1
        self.cpu.append(("cudaLaunchKernel", t, t + 1, thread, -1,
                         self.next_id))
        self.kernels.append((f"k{self.next_id}", self.t_dev,
                             self.t_dev + ms * 1e3, self.next_id))
        self.t_dev += ms * 1e3 + 1

    def event(self, name, start, end, thread=1, seq=-1):
        self.next_id += 1
        self.cpu.append((name, start, end, thread, seq, self.next_id))


def _train_trace() -> TraceData:
    """Two steps: the forward ranges on thread 1 nested as in the port,
    the backward nodes on thread 2, after the forward, each node named
    ``...Backward`` with its forward op's sequence number."""
    b = _Events()
    for step in range(STEPS):
        t0 = step * 10_000
        b.event("train.step", t0, t0 + 9_000)
        b.launch(t0 + 8_900, 1, STEP_SELF_MS)
        spans = {"encoder.rnn": (t0 + 3_000, t0 + 4_950),
                 "rnn.recurrence": (t0 + 4_000, t0 + 4_900)}
        back = t0 + 6_000
        for i, (name, ops, ms) in enumerate(LAYOUT):
            s, e = spans.get(name, (t0 + 1_000 * (i + 1),
                                    t0 + 1_000 * (i + 1) + 500))
            b.event(name, s, e)
            if ms:
                b.launch(s + 10, 1, ms)
            for seq, fwd, bwd in ops:
                seq += 10 * step
                b.event(f"aten::op{seq}", s + 20, s + 60, seq=seq)
                b.launch(s + 30, 1, fwd)
                b.event(f"Op{seq}Backward0", back, back + 100, thread=2,
                        seq=seq)
                b.launch(back + 10, 2, bwd)
                back += 200
    return TraceData(b.kernels, [], b.cpu, (0.0, b.t_dev), steps=STEPS)


def _decode_trace() -> TraceData:
    b = _Events()
    for step in range(STEPS):
        t0 = step * 100_000
        b.event("train.upload", t0, t0 + HOST_MS["train.upload"] * 1e3)
        b.launch(t0 + 5_000, 1, 1.0)
        b.event("evaluate.pick_best", t0 + 10_000, t0 + 50_000)
        b.event("evaluate.nbest_texts", t0 + 10_100,
                t0 + 10_100 + HOST_MS["evaluate.nbest_texts"] * 1e3)
        b.event("lm.rescore", t0 + 20_000,
                t0 + 20_000 + HOST_MS["lm.rescore"] * 1e3)
    return TraceData(b.kernels, [], b.cpu, (0.0, b.t_dev), steps=STEPS)


def _reader(name: str):
    from asrbench import run
    return run._reader(os.path.join(ROOT, "asrbench", "metrics",
                                    name + ".py"))


def _run(kind: str, trace, logs=None):
    return SimpleNamespace(kind=kind, out={"trace": trace}, cfg={},
                           sample_rate=16000,
                           log=(logs.append if logs is not None
                                else lambda m: None))


def _layer_ms(name: str) -> float:
    return next(sum(f + b for _, f, b in ops) + ms
                for n, ops, ms in LAYOUT if n == name)


@pytest.mark.parametrize("metric,want", [
    ("recurrence_ms.train", 4.0 + 6.0),
    ("rnn_other_ms.train", 0.5 + 0.7),
    ("ctc_ms.train", 0.3 + 0.4),
    ("adam_ms.train", 1.5),
    ("step_other_ms.train", STEP_SELF_MS),
])
def test_train_readers(metric, want):
    assert _reader(metric).read(_run("train", _train_trace())) == \
        pytest.approx(want)
    assert _reader(metric).read(_run("decode", _train_trace())) is None


def test_layers_add_up_to_the_step():
    """The step's kernels are its layers' and its own, each counted once:
    a range's self time is the range less the ranges nested in it."""
    tr = _train_trace()
    parts = sum(_reader(m).read(_run("train", tr)) for m in (
        "recurrence_ms.train", "rnn_other_ms.train", "ctc_ms.train",
        "adam_ms.train", "step_other_ms.train"))
    parts += _layer_ms("features.extract") + _layer_ms("encoder.frontend")
    assert parts == pytest.approx(tr.kernel_ms(("k",)) / STEPS)


@pytest.mark.parametrize("metric,span", [
    ("upload_host_ms.decode", "train.upload"),
    ("nbest_texts_ms", "evaluate.nbest_texts"),
    ("lm_rescore_ms", "lm.rescore"),
])
def test_decode_host_readers(metric, span):
    assert _reader(metric).read(_run("decode", _decode_trace())) == \
        pytest.approx(HOST_MS[span])
    assert _reader(metric).read(_run("train", _decode_trace())) is None


@pytest.mark.parametrize("metric", ["recurrence_ms.train", "lm_rescore_ms"])
def test_absent_range_is_none_and_logged(metric):
    """A trace without the range (the parent of this change, or a kernel
    taken off the path) reads None and says so."""
    kind = "train" if metric.endswith(".train") else "decode"
    tr = _decode_trace() if kind == "train" else _train_trace()
    logs = []
    assert _reader(metric).read(_run(kind, tr, logs)) is None
    assert logs and "no" in logs[0]


@pytest.mark.parametrize("counts,want", [
    ({"lm.rescore.lookups": 200, "lm.rescore.scored": 150}, 25.0),
    ({}, None),
])
def test_rescore_cache_hits(monkeypatch, counts, want):
    from ctc_asr_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_counts", dict(counts))
    got = _reader("rescore_cache_hits").read(_run("decode", _decode_trace()))
    assert got == (pytest.approx(want) if want is not None else None)


NEW = ("recurrence_ms.train", "rnn_other_ms.train", "ctc_ms.train",
       "adam_ms.train", "step_other_ms.train", "upload_host_ms.decode",
       "nbest_texts_ms", "lm_rescore_ms", "rescore_cache_hits")
PORT_SPANS = {"train": {"train.step", "train.upload", "features.extract",
                        "encoder.frontend", "encoder.rnn", "rnn.recurrence",
                        "ctc.loss", "optim.adam"},
              "decode": {"train.upload", "features.extract",
                         "encoder.frontend", "encoder.rnn",
                         "rnn.recurrence", "evaluate.pick_best",
                         "evaluate.nbest_texts", "lm.rescore"}}


@pytest.mark.parametrize("cell", ["ds2_train_b64", "ds3_decode_fusion_b128"])
def test_readers_on_tiny_traced_run(cell):
    """A traced tiny CPU run holds the port's spans; every new reader
    returns a value or None on it, and raises nothing."""
    import torch
    from asrbench import common
    ctx = common.load_ctx(cell, 2**31 + 7, 0.3, True, True,
                          time.perf_counter())
    torch.set_num_threads(1)
    driver = importlib.import_module(
        f"asrbench.drivers.{ctx.cell_file['driver']}")
    out = driver.run(ctx)
    kind = ctx.cell_file["driver"]
    names = {c[0] for c in out["trace"].cpu}
    assert PORT_SPANS[kind] <= names
    run = SimpleNamespace(kind=kind, out=out, cfg=out["cfg"],
                          sample_rate=ctx.mix["sample_rate"],
                          log=lambda m: None)
    for metric in NEW:
        value = _reader(metric).read(run)
        assert value is None or isinstance(value, float), metric
