"""The copied arithmetic reproduces the records it was copied with: the
TPU record's FLOPs a step (``bench.py``'s ``model_step_flops``, now the
conv_bilstm family's ``step_flops``: ds3 2.33e13 and ds2 6.96e12 at
B=128 x 8 s) and the bound column of ``PERF.md``'s kernel table at its
shapes (``chip_smoke.py``)."""

import json
import os

import numpy as np
import pytest

from benchhelp import ROOT
from asrbench import flops
from asrbench.reference import conv_bilstm


def _cfg(name):
    with open(os.path.join(ROOT, "asrbench", "configs", f"{name}.json")) as f:
        return json.load(f)["config"]


@pytest.mark.parametrize("name,want", [("ds3", 2.33e13), ("ds2", 6.96e12)])
def test_model_step_flops(name, want):
    assert conv_bilstm.step_flops(_cfg(name), 128, 8.0) == \
        pytest.approx(want, rel=3e-3)


@pytest.mark.parametrize("H,k2,k3", [(512, 0.217, 0.313), (800, 0.529, 0.529)])
def test_lstm_bounds(H, k2, k3):
    b2, b3 = flops.lstm_bounds(2, 399, 128, H)
    assert b2["bound_ms"] == pytest.approx(k2, abs=5e-4)
    assert b3["bound_ms"] == pytest.approx(k3, abs=5e-4)


@pytest.mark.parametrize("form,want", [("2-D", 1.585), ("full band", 3.025),
                                       ("blocked", 2.021)])
def test_frontend_bound(form, want):
    cfg = _cfg("ds2")
    T = flops.num_frames(128000, cfg["features"])
    assert flops.frontend_bound(cfg, 128, T, form)["bound_ms"] == \
        pytest.approx(want, abs=5e-4)


def test_beam_bound():
    rng = np.random.default_rng(8)      # chip_smoke.phase_beam's draws
    rng.standard_normal((128, 400, 29))
    lens = rng.integers(200, 401, 128).astype(np.int32)
    lens[0], lens[-1] = 400, 0
    bd = flops.beam_bound(lens, 128, 64, 29, 400, 1, 28 ** 3 * 28 * 4)
    assert bd["bound_ms"] == pytest.approx(0.0235, abs=5e-5)
    assert bd["bound_by"] == "operations"


def test_encoder_frames():
    cfg = _cfg("ds3")
    assert flops.num_frames(128000, cfg["features"]) == 798
    assert conv_bilstm.encoder_frames(128000, cfg) == 399
