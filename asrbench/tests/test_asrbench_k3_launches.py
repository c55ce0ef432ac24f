"""``k3_clustered_launches.train`` on a hand-made trace and counters: K3
kernels a traced step times the clustered share of the process's K3
launches; None where the program has no such counter or counted no
launch, or the run is not a traced train run."""

from types import SimpleNamespace

import pytest

from asrbench.trace import TraceData
from test_asrbench_spans import _decode_trace, _reader, _run

STEPS = 2
K3_A_STEP = 3


def _k3_trace() -> TraceData:
    kernels, t = [], 0.0
    for step in range(STEPS):
        for i in range(K3_A_STEP):
            for name in ("void lstm_fwd_persistent_kernel<32>()",
                         "void lstm_bwd_persistent_kernel<32, 2>()",
                         "gemm"):
                kernels.append((name, t, t + 10.0, len(kernels)))
                t += 11.0
    return TraceData(kernels, [], [], (0.0, t), steps=STEPS)


@pytest.mark.parametrize("counts,want", [
    ({"launches": 40, "clustered_launches": 40}, 3.0),
    ({"launches": 40, "clustered_launches": 10}, 0.75),
    ({"launches": 40, "clustered_launches": 0}, 0.0),
    ({"launches": 0, "clustered_launches": 0}, None),
    ({"launches": 40}, None),
])
def test_k3_clustered_launches(monkeypatch, counts, want):
    from ctc_asr_tpu_torch.ops import lstm_cuda
    monkeypatch.setattr(lstm_cuda, "lstm_bwd", SimpleNamespace(**counts))
    reader = _reader("k3_clustered_launches.train")
    got = reader.read(_run("train", _k3_trace()))
    assert got == (pytest.approx(want) if want is not None else None)
    assert reader.read(_run("decode", _decode_trace())) is None
