"""The port's accuracy-ladder runners (``ctc_asr_tpu_torch.scripts``) held
against the repo's ``scripts/`` on the CPU, and the port's archived ladder
run held against the reference's record utterance by utterance.

- ``rung_cfg`` equals the JAX runner's, field by field, for every rung;
- a tiny ladder (n 8 / 4 / 4, presets narrowed to one RNN layer of 32
  units, a dense frontend of 16, convs of 4 channels, beam 2) writes the
  records, sidecars and loss curves that the reference's run wrote, with
  its record keys and sidecar names; ``continue_rung`` resumes one of its
  rungs;
- ``analyze_ladder`` prints what the JAX script prints on the reference's
  archive, and ``cli compare`` pairs two sidecars by utterance;
- ``init_params`` of each ladder preset matches the reference's in leaf
  names, shapes, Glorot bounds and the forget-gate biases;
- the committed H100 archive (``ctc_asr_tpu_torch/results/
  ladder_hard_h100``) has every rung of the reference's, and it, its
  first run (``run1/``) and the seed-43 reruns have the same 512 test
  utterances in the same order (equal ``(wc, cc)`` columns).
"""

import contextlib
import dataclasses as dc
import importlib.util
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "docs", "results", "ladder_hard_r4")
H100 = os.path.join(REPO, "ctc_asr_tpu_torch", "results", "ladder_hard_h100")
REF_SIDECARS = sorted(os.listdir(os.path.join(REF, "per_utt")))
# the reference's r4 invocation (BASELINE.md)
R4_RUNGS = ["--rungs", "pr1,ds2,ds3,ds3sa", "--specaug-ab"]
TINY = ["--device", "cpu", "--n-train", "8", "--n-dev", "4", "--n-test",
        "4", "--batch", "2", "--steps-scale", "0.001", "--lm-weights",
        "0.2,0.6"]
# (rung, preset, train_dir suffix, steps at --steps-scale 2, lr)
RUNGS = [("pr1", "pr1_mfcc_uni", "pr1", 5000, 5e-4),
         ("ds2", "conv_bilstm3", "ds2", 4000, 5e-4),
         ("ds2sa", "conv_bilstm3", "ds2_specaug", 4000, 5e-4),
         ("ds3", "deepspeech_beam", "ds3", 4000, 3e-4),
         ("ds3sa", "deepspeech_beam", "ds3sa", 4000, 3e-4)]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(dirpath):
    with open(os.path.join(dirpath, "ladder_results.jsonl")) as f:
        return [json.loads(line) for line in f]


def _sidecar(dirpath, name):
    with open(os.path.join(dirpath, "per_utt", name)) as f:
        return json.load(f)


def _decode_kind(decode):
    return re.sub(r"=[0-9.]+", "=", decode)


def _shape(records):
    return [(r["rung"], _decode_kind(r["decode"]), sorted(r))
            for r in records]


@pytest.mark.parametrize("rung,preset_name,suffix,steps,lr", RUNGS)
def test_rung_cfg_matches_the_reference(rung, preset_name, suffix, steps,
                                        lr):
    from ctc_asr_tpu_torch.scripts import run_ladder_hard as port
    ref = _load_script("run_ladder_hard")
    man = {k: f"/data/{k}.csv" for k in ("train", "dev", "test")}
    for extra in ((), ("ulaw", "/data/cache")):
        want = ref.rung_cfg(preset_name, man, "/out", suffix, steps, 32, lr,
                            *extra)
        got = port.rung_cfg(preset_name, man, "/out", suffix, steps, 32, lr,
                            *extra)
        assert dc.asdict(got) == dc.asdict(want)
    assert got.train.train_dir == f"/out/train_{suffix}"
    assert (got.model.dropout, got.data.num_buckets) == (0.1, 2)


def test_train_seed_flag_changes_the_seed_alone():
    """``--train-seed`` (a third seed of an arm) replaces the train seed
    and nothing else; without it the rung's config is the reference's
    (``test_rung_cfg_matches_the_reference``)."""
    from ctc_asr_tpu_torch.scripts import run_ladder_hard as port
    man = {k: f"/data/{k}.csv" for k in ("train", "dev", "test")}
    assert port.parse_args(["--out", "/o"]).train_seed is None
    assert port.parse_args(["--out", "/o", "--train-seed", "44"]
                           ).train_seed == 44
    base = port.rung_cfg("deepspeech_beam", man, "/out", "ds3sa", 4000, 32,
                         3e-4)
    seeded = port.rung_cfg("deepspeech_beam", man, "/out", "ds3sa", 4000, 32,
                           3e-4, seed=44)
    assert seeded.train.seed == 44 and base.train.seed != 44
    assert dc.asdict(dc.replace(seeded, train=dc.replace(
        seeded.train, seed=base.train.seed))) == dc.asdict(base)


def _narrow(monkeypatch):
    """Presets at test size: a 40 ms hop, one RNN layer of 32 units, a
    dense frontend of 16, convs of 4 channels with a time stride of 2,
    beam 2 (the ladder's flow and records are unchanged)."""
    from ctc_asr_tpu_torch import config
    orig = config.preset

    def narrow(name):
        cfg = orig(name)
        return dc.replace(
            cfg, features=dc.replace(cfg.features, hop_ms=40.0),
            model=dc.replace(cfg.model, rnn_layers=1, rnn_units=32,
                             dense_units=16, conv_channels=(4, 4),
                             conv_strides=((2, 2), (1, 2))),
            decode=dc.replace(cfg.decode,
                              beam_width=min(cfg.decode.beam_width, 2)))
    monkeypatch.setattr(config, "preset", narrow)


@pytest.fixture(scope="module")
def tiny_ladder(tmp_path_factory):
    """The reference's r4 invocation at tiny scale, archived."""
    from ctc_asr_tpu_torch.scripts import run_ladder_hard
    mp = pytest.MonkeyPatch()
    _narrow(mp)
    root = tmp_path_factory.mktemp("ladder")
    out, arch = str(root / "out"), str(root / "archive")
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log:
            records = run_ladder_hard.main(
                ["--out", out, "--archive", arch, *TINY, *R4_RUNGS])
    finally:
        mp.undo()
    return {"out": out, "archive": arch, "records": records,
            "log": log.getvalue()}


def test_tiny_ladder_writes_the_reference_records(tiny_ladder):
    assert _shape(tiny_ladder["records"]) == _shape(_records(REF))
    assert _records(tiny_ladder["archive"]) == tiny_ladder["records"]
    assert json.loads(tiny_ladder["log"].strip().splitlines()[-2]) == {
        "ladder": tiny_ladder["records"]}
    for r in tiny_ladder["records"]:
        assert 0.0 <= r["test_wer"] and np.isfinite(r["rtf"])
        lo, hi = r["test_wer_ci95"]
        assert lo <= r["test_wer"] <= hi


def test_tiny_ladder_writes_the_reference_sidecars(tiny_ladder):
    arch = tiny_ladder["archive"]
    assert sorted(os.listdir(os.path.join(arch, "per_utt"))) == REF_SIDECARS
    for name in REF_SIDECARS:
        got, ref = _sidecar(arch, name), _sidecar(REF, name)
        assert (got["rung"], got["decode"]) == (ref["rung"], ref["decode"])
        assert len(got["per_utt"]) == 4
        assert all(len(u) == 4 for u in got["per_utt"])
    curves = sorted(n for n in os.listdir(arch) if n.endswith(".jsonl"))
    assert curves == sorted(n for n in os.listdir(REF)
                            if n.endswith(".jsonl"))


def test_tiny_ladder_selects_from_its_grids(tiny_ladder):
    chosen = []
    for r in tiny_ladder["records"]:
        m = re.search(r"charlm\(w=([0-9.]+)\)(\+wordlm\(a=([0-9.]+)\))?",
                      r["decode"])
        if m:
            assert float(m.group(1)) in (0.2, 0.6)
            if m.group(3) is not None:
                assert float(m.group(3)) in (0.0, 0.3, 0.6, 1.0, 2.0)
            chosen.append(m.group(0))
    assert len(chosen) == 4       # fusion and rescoring, two ds3 chains


def test_continue_rung_resumes_a_rung(tiny_ladder, monkeypatch):
    from ctc_asr_tpu_torch.scripts import continue_rung
    _narrow(monkeypatch)
    out = tiny_ladder["out"]
    n = len(_records(out))
    with contextlib.redirect_stdout(io.StringIO()) as log:
        continue_rung.main(["--out", out, "--rung", "ds2", "--steps", "4",
                            "--batch", "2", "--device", "cpu"])
    assert "resumed from step 2" in log.getvalue()
    recs = _records(out)
    assert len(recs) == n + 1
    rec = recs[-1]
    assert (rec["rung"], rec["decode"], rec["steps"], rec["continued"]) == (
        "conv_bilstm3", "greedy", 4, True)
    assert sorted(rec) == sorted(
        ["rung", "decode", "steps", "continued", "train_wall_s", "dev_wer",
         "test_wer", "test_cer", "test_wer_ci95", "test_cer_ci95", "rtf"])
    side = _sidecar(out, "conv_bilstm3__greedy@4.json")
    assert len(side["per_utt"]) == 4


def test_ds2sa_rung_alone(tmp_path, monkeypatch):
    from ctc_asr_tpu_torch.scripts import run_ladder_hard
    _narrow(monkeypatch)
    out = str(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        records = run_ladder_hard.main(["--out", out, *TINY, "--rungs",
                                        "ds2sa"])
    ref = [r for r in _records(REF) if r["rung"] == "conv_bilstm3+specaug"]
    assert _shape(records) == _shape(ref)
    assert os.listdir(os.path.join(out, "per_utt")) == [
        "conv_bilstm3+specaug__greedy.json"]
    assert os.path.isdir(os.path.join(out, "train_ds2_specaug", "ckpt"))


@pytest.mark.parametrize("argv", [
    ["--rungs", "pr1"], ["--rungs", "ds3", "--archive", "x"]])
def test_runner_refuses_to_run_without_a_gpu(tmp_path, monkeypatch, argv):
    from ctc_asr_tpu_torch.scripts import continue_rung, run_ladder_hard
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ladder_hard.main(["--out", out, *argv])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        continue_rung.main(["--out", out, "--rung", "ds2", "--steps", "2"])
    assert not os.path.exists(out)


@pytest.mark.parametrize("top", [4, 5])
def test_analyze_ladder_prints_what_the_reference_prints(top, monkeypatch):
    from ctc_asr_tpu_torch.scripts import analyze_ladder
    ref = _load_script("analyze_ladder")
    argv = ["--dir", REF, "--top", str(top)]
    with contextlib.redirect_stdout(io.StringIO()) as want:
        monkeypatch.setattr(sys, "argv", ["analyze_ladder.py", *argv])
        ref.main()
    with contextlib.redirect_stdout(io.StringIO()) as got:
        analyze_ladder.main(argv)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count(" -> ") == top * (top - 1) // 2


def test_cli_compare_pairs_by_utterance(tmp_path, capsys):
    """``cli compare`` holds a sidecar against another run's; it refuses a
    pair whose per-utterance ``(wc, cc)`` differ (another split or order)."""
    from ctc_asr_tpu_torch import cli
    ref = os.path.join(REF, "per_utt", REF_SIDECARS[0])
    assert cli.main(["compare", ref, ref, "--resamples", "200"]) == 0
    out = capsys.readouterr().out
    got = json.loads(out[:out.index("\n#")])
    assert got["wer_delta"] == 0.0 and got["wer_delta_ci95"] == [0.0, 0.0]
    assert "# statistically tied" in out
    side = _sidecar(REF, REF_SIDECARS[0])
    side["per_utt"][7][1] += 1
    other = tmp_path / REF_SIDECARS[0]
    other.write_text(json.dumps(side))
    with pytest.raises(ValueError, match=r"\(wc, cc\) differ"):
        cli.main(["compare", str(other), ref])


@pytest.mark.parametrize("preset_name", ["pr1_mfcc_uni", "conv_bilstm3",
                                         "deepspeech_beam"])
def test_init_params_match_the_reference(preset_name):
    import jax
    from ctc_asr_tpu.checkpoint import _flatten
    from ctc_asr_tpu.config import preset as j_preset
    from ctc_asr_tpu.models import init_params as j_init
    from ctc_asr_tpu_torch.config import preset
    from ctc_asr_tpu_torch.models import init_params
    cfg = preset(preset_name)
    feat = cfg.features.feature_dim
    want = _flatten(j_init(jax.random.PRNGKey(0),
                           j_preset(preset_name).model, feat))
    got = {k: v.numpy() for k, v in init_params(
        cfg.model, feat, torch.Generator().manual_seed(0)).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, k
        if k.endswith("/b"):
            # zeros, and 1 on the LSTM forget gate (gate order i, f, g, o)
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        fan_in, fan_out = w.shape[-2], w.shape[-1]
        rf = int(np.prod(w.shape[:-2])) if w.ndim > 2 else 1
        limit = float(np.sqrt(6.0 / (rf * (fan_in + fan_out))))
        for name, a in (("port", g), ("reference", w)):
            assert np.abs(a).max() <= limit * (1 + 1e-6), (name, k)
            if a.size >= 4096:
                # uniform on [-limit, limit]: reaches near both ends, std
                # limit / sqrt(3), mean 0
                assert np.abs(a).max() >= 0.99 * limit, (name, k)
                np.testing.assert_allclose(a.std(), limit / np.sqrt(3),
                                           rtol=0.05, err_msg=f"{name} {k}")
                assert abs(a.mean()) <= 0.05 * limit, (name, k)


def _h100_records():
    return _records(H100)


def test_h100_archive_has_every_rung_of_the_reference():
    assert _shape(_h100_records()) == _shape(_records(REF))
    assert sorted(os.listdir(os.path.join(H100, "per_utt"))) == REF_SIDECARS
    for rec, ref in zip(_h100_records(), _records(REF)):
        assert rec.get("steps") == ref.get("steps")


@pytest.mark.parametrize("name", REF_SIDECARS)
def test_h100_sidecar_has_the_reference_utterances(name):
    got, ref = _sidecar(H100, name), _sidecar(REF, name)
    assert (got["rung"], got["decode"]) == (ref["rung"], ref["decode"])
    assert len(got["per_utt"]) == len(ref["per_utt"]) == 512
    assert [(u[1], u[3]) for u in got["per_utt"]] == [
        (u[1], u[3]) for u in ref["per_utt"]]


@pytest.mark.parametrize("name", REF_SIDECARS)
def test_h100_first_run_has_the_reference_utterances(name):
    """The first full run (``run1/``, superseded by the run of the final
    runner at the archive's top level) on the same split in the same
    order, with every rung's record."""
    run1 = os.path.join(H100, "run1")
    got, ref = _sidecar(run1, name), _sidecar(REF, name)
    assert (got["rung"], got["decode"]) == (ref["rung"], ref["decode"])
    assert [(u[1], u[3]) for u in got["per_utt"]] == [
        (u[1], u[3]) for u in ref["per_utt"]]
    assert _shape(_records(run1)) == _shape(_records(REF))


@pytest.mark.parametrize("name", ["pr1_mfcc_uni__greedy.json",
                                  "deepspeech_beam__greedy.json",
                                  "deepspeech_beam__beam64.json"])
def test_h100_seed43_rerun_has_the_reference_utterances(name):
    """The rungs whose first records were not tied, rerun at seed 43
    (``cli evaluate --dump-utts``), on the same split in the same order."""
    got = _sidecar(os.path.join(H100, "seed43"), name)
    ref = _sidecar(REF, name)
    assert [(u[1], u[3]) for u in got["per_utt"]] == [
        (u[1], u[3]) for u in ref["per_utt"]]
