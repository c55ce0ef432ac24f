"""The port's round-1 synth runners (``ctc_asr_tpu_torch.scripts.
run_synth_*``) held against the repo's ``scripts/run_synth_*.py`` on the
CPU.

Both runners of a pair run with ``train`` / ``evaluate`` (and, for the
LM runner, the checkpoint read) replaced by recorders, so nothing is
trained: the configs they would train and decode with must be equal,
field by field, and the JSON line each prints must have the same keys.
The one intended difference: the e2e runner's ``beam_xla`` decoder is
the plain beam search (``use_pallas=False``); the reference's config
named none and took the default, the kernel. The cheapest runner,
``run_synth_e2e``, then runs for real at a few steps.
"""

import contextlib
import dataclasses as dc
import importlib
import importlib.util
import io
import json
import os
import sys

import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (runner, arguments of both; the small corpora keep the generation short)
RUNNERS = [
    ("run_synth_e2e", ["--n", "8"]),
    ("run_synth_ds2", ["--n", "8"]),
    ("run_synth_ds3", []),
    ("run_synth_holdout", ["--n-train", "8", "--n-eval", "2",
                           "--specaugment"]),
    ("run_synth_holdout", ["--steps", "40", "--n-train", "4",
                           "--n-eval", "1"]),
    ("run_synth_lm", []),
]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorders(monkeypatch, pkg, seen):
    """Replace ``pkg``'s train / evaluate / checkpoint read by recorders
    of the configs they are given."""
    train_mod = importlib.import_module(f"{pkg}.train")
    eval_mod = importlib.import_module(f"{pkg}.evaluate")
    ckpt_mod = importlib.import_module(f"{pkg}.checkpoint")

    def train(cfg, *a, **k):
        seen.append(("train", cfg))
        return {"step": cfg.train.total_steps, "params": {}}

    def evaluate(cfg, *a, **k):
        seen.append(("evaluate", cfg))
        return {"wer": 0.0, "cer": 0.0, "rtf": 0.0, "utterances": 1}

    monkeypatch.setattr(train_mod, "train", train)
    monkeypatch.setattr(eval_mod, "evaluate", evaluate)
    if pkg == "ctc_asr_tpu":
        monkeypatch.setattr(train_mod, "init_train_state", lambda cfg: None)
        monkeypatch.setattr(ckpt_mod, "latest_checkpoint", lambda d: d)
        monkeypatch.setattr(ckpt_mod, "load_checkpoint",
                            lambda p, t: ({"params": None}, {}))
    else:
        monkeypatch.setattr(ckpt_mod, "load_params",
                            lambda path, cfg, device="cpu": {})


def _run_reference(name, argv, monkeypatch):
    seen = []
    _recorders(monkeypatch, "ctc_asr_tpu", seen)
    ref = _load_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ref.main()
    return seen, json.loads(out.getvalue().strip().splitlines()[-1])


def _run_port(name, argv, monkeypatch):
    seen = []
    _recorders(monkeypatch, "ctc_asr_tpu_torch", seen)
    port = importlib.import_module(f"ctc_asr_tpu_torch.scripts.{name}")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = port.main([*argv, "--device", "cpu"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    return seen, res


@pytest.mark.parametrize("name,argv", RUNNERS)
def test_runner_configs_match_the_reference(name, argv, tmp_path,
                                            monkeypatch):
    work = ["--dir" if name == "run_synth_lm" else "--out", str(tmp_path)]
    if name == "run_synth_lm":
        # the corpus that run_synth_ds2 leaves
        from ctc_asr_tpu_torch.data.synth import generate_corpus
        generate_corpus(str(tmp_path / "corpus"), num_utterances=4, seed=1,
                        min_words=2, max_words=5)
    got, got_line = _run_port(name, [*argv, *work], monkeypatch)
    want, want_line = _run_reference(name, [*argv, *work], monkeypatch)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert got[0][0] == ("evaluate" if name == "run_synth_lm" else "train")
    assert sorted(got_line) == sorted(want_line)
    for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
        w = dc.asdict(w)
        if name == "run_synth_e2e" and i == 2:        # beam_xla
            assert w["decode"]["use_pallas"] is True
            w["decode"]["use_pallas"] = False
        assert dc.asdict(g) == w, (name, i)


@pytest.mark.parametrize("name", ["run_synth_e2e", "run_synth_ds2",
                                  "run_synth_ds3", "run_synth_holdout",
                                  "run_synth_lm"])
def test_runner_refuses_to_run_without_a_gpu(name, tmp_path, monkeypatch):
    port = importlib.import_module(f"ctc_asr_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flag = "--dir" if name == "run_synth_lm" else "--out"
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main([flag, out])
    assert not os.path.exists(out)


def test_e2e_runner_trains_and_decodes_three_ways(tmp_path):
    """``run_synth_e2e`` for real at 3 steps: a checkpoint, and the three
    decoders' WER, CER and RTF under the reference's keys."""
    from ctc_asr_tpu_torch.scripts import run_synth_e2e
    with contextlib.redirect_stdout(io.StringIO()):
        res = run_synth_e2e.main(["--device", "cpu", "--out", str(tmp_path),
                                  "--steps", "3", "--n", "8", "--batch",
                                  "2"])
    assert res["train_steps"] == 3
    assert os.path.exists(tmp_path / "train" / "ckpt" / "step_00000003.npz")
    for tag in ("greedy", "beam_xla", "beam_pallas"):
        assert res[f"{tag}_wer"] >= 0 and res[f"{tag}_cer"] >= 0
        assert res[f"{tag}_rtf"] > 0
    # the plain beam search and the kernel's CPU path: the same function
    assert res["beam_xla_wer"] == res["beam_pallas_wer"]
    assert res["beam_xla_cer"] == res["beam_pallas_cer"]
