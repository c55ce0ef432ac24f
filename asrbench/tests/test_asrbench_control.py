"""The control (the reference in float8 in the program's place) at a size a
test run holds: it reads well above the program on the same seeds, and
the decode cell's fails its limit (on the chip it is read at the cells'
own sizes by ``controls.py``)."""

import json

import pytest


def _readings(capsys, cell, *flags):
    from asrbench import controls
    capsys.readouterr()
    assert controls.main(["--workload", cell, "--seeds", "1,2", "--tiny",
                          *flags]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    return {(x["seed"], x["kind"]): x for x in lines}


def test_train_control_reads_above_program(capsys):
    r = _readings(capsys, "ds2_train_b64", "--program", "--control")
    for seed in (1, 2):
        prog = r[(seed, "program")]["readings"]
        ctrl = r[(seed, "control_fp8")]["readings"]
        assert prog and all(ctrl[k] > 3 * prog[k] for k in ("loss_gap",
                                                           "grad_gap"))


@pytest.mark.parametrize("cell", ["ds2_decode_greedy_b128"])
def test_decode_control_fails(capsys, cell):
    r = _readings(capsys, cell, "--program", "--control")
    for seed in (1, 2):
        assert r[(seed, "program")]["correct"] is True
        assert r[(seed, "control_fp8")]["correct"] is False
