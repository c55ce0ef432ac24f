"""``attention_fused_share.train`` on hand-made counters: the process's
fused core calls over all its core calls; None, with a message, where
the program counted no call (a program without the counters), and None
where the run is not a traced train run."""

import pytest

from ctc_asr_tpu_torch.utils import profiling
from test_asrbench_spans import _decode_trace, _reader, _run

CALLS, FUSED = "attention.core.calls", "attention.core.fused_calls"


@pytest.mark.parametrize("counts,want", [
    ({CALLS: 36, FUSED: 36}, 1.0),
    ({CALLS: 36, FUSED: 9}, 0.25),
    ({CALLS: 36}, 0.0),
    ({CALLS: 0, FUSED: 0}, None),
    ({}, None),
])
def test_attention_fused_share(monkeypatch, counts, want):
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    reader = _reader("attention_fused_share.train")
    logs = []
    got = reader.read(_run("train", _decode_trace(), logs))
    assert got == (pytest.approx(want) if want is not None else None)
    assert bool(logs) == (want is None)
    assert reader.read(_run("decode", _decode_trace())) is None
    assert reader.read(_run("train", None)) is None
