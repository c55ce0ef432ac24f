"""The port's OOV rung and n=4096 settler (``ctc_asr_tpu_torch.scripts.
run_oov``) held against ``scripts/run_oov.py`` on the CPU, and the
port's archived r4big / OOV runs held against the reference's records
utterance by utterance.

- ``arm_cfg`` equals the JAX runner's, field by field;
- the settler's and the OOV splits (the port's ``generate_hard_split``
  with the exclusion set) equal the JAX package's, manifest and audio;
- a tiny ``run_oov`` on a tiny two-arm ladder (presets narrowed as in
  ``tests/test_torch_ladder.py``, each arm's checkpoint named
  ``step_00008000.npz``) writes the reference's 19 records (keys,
  ``arm`` / ``decode`` / ``compare`` labels) and its 11 sidecar names;
- the committed H100 archives (``ctc_asr_tpu_torch/results/
  ladder_hard_r4big_h100`` and ``oov_h100``) have the same utterances in
  the same order as the TPU's (equal ``(wc, cc)`` columns): 1024 r4big
  test, 4096 ``bigtest`` and 1024 ``oov_test`` utterances.
"""

import contextlib
import dataclasses as dc
import importlib.util
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "docs", "results", "oov_r5")
REF_R4BIG = os.path.join(REPO, "docs", "results", "ladder_hard_r4big")
H100 = os.path.join(REPO, "ctc_asr_tpu_torch", "results", "oov_h100")
H100_R4BIG = os.path.join(REPO, "ctc_asr_tpu_torch", "results",
                          "ladder_hard_r4big_h100")
REF_SIDECARS = sorted(os.listdir(os.path.join(REF, "per_utt")))
# the r4big sidecars that the ds2sa / ds3sa rungs and their continuation
# to 8000 steps write (the reference's archive also holds a feature-cache
# and a u-law arm of ds2sa, runs of other wire formats)
R4BIG_SIDECARS = sorted(
    n for n in os.listdir(os.path.join(REF_R4BIG, "per_utt"))
    if "_fcache" not in n and "_ulaw" not in n)
TINY_LADDER = ["--device", "cpu", "--n-train", "8", "--n-dev", "4",
               "--n-test", "4", "--batch", "2", "--steps-scale", "0.001",
               "--lm-weights", "0.2,0.6", "--rungs", "ds2sa,ds3sa"]
TINY_OOV = ["--device", "cpu", "--n-bigtest", "4", "--n-oov-dev", "4",
            "--n-oov-test", "4", "--lm-sentences", "64"]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _sidecar(dirpath, name):
    with open(os.path.join(dirpath, "per_utt", name)) as f:
        return json.load(f)


def _label(rec):
    """A record's labels without the selected weights' values."""
    if "compare" in rec:
        return ("compare", rec["compare"], rec["a"], rec["b"])
    return ("arm", rec["arm"], re.sub(r"=[0-9.]+", "=", rec["decode"]),
            rec["split"])


def _shape(records):
    return [(_label(r), sorted(r)) for r in records]


@pytest.mark.parametrize("preset_name", ["conv_bilstm3", "deepspeech_beam"])
def test_arm_cfg_matches_the_reference(preset_name):
    from ctc_asr_tpu_torch.scripts import run_oov
    ref = _load_script("run_oov")
    for batch in (32, 8):
        want = ref.arm_cfg(preset_name, "/data/bigtest.csv", batch)
        got = run_oov.arm_cfg(preset_name, "/data/bigtest.csv", batch)
        assert dc.asdict(got) == dc.asdict(want)
    assert (got.model.dropout, got.data.num_buckets) == (0.1, 2)


def test_splits_match_the_reference(tmp_path):
    """``make_splits`` against the JAX package's ``generate_hard_split``
    with the reference's seeds, speaker pools and split ids, under an
    exclusion set that removes transcripts the generators would draw."""
    from ctc_asr_tpu.data import read_manifest as j_read
    from ctc_asr_tpu.data.synth import build_oov_vocabulary, build_vocabulary
    from ctc_asr_tpu.data.synth import generate_hard_split as j_split
    from ctc_asr_tpu_torch.data import read_manifest
    from ctc_asr_tpu_torch.scripts import run_oov
    n = 6
    free = run_oov.make_splits(str(tmp_path / "free"), set(), n, n, n)
    exclude = set()
    for split in ("bigtest", "oov_dev", "oov_test"):
        exclude.update(u.transcript for u in read_manifest(free[split])[:2])
    port = run_oov.make_splits(str(tmp_path / "port"), exclude, n, n, n)
    base = build_vocabulary(384, seed=7 + 1234)
    oov = build_oov_vocabulary(384, 384, seed=7 + 1234)
    assert (port["base_vocab"], port["oov_vocab"]) == (base, oov)
    assert not set(base) & set(oov)
    ref_dir = str(tmp_path / "ref")
    for split, vocab, seed, spk, nspk, sid in (
            ("bigtest", base, 7001, 1000, 12, 10),
            ("oov_dev", oov, 7002, 0, 32, 11),
            ("oov_test", oov, 7003, 1000, 12, 12)):
        want = j_read(j_split(ref_dir, split, vocab, n, seed=seed,
                              spk_base=spk, n_speakers=nspk, split_id=sid,
                              exclude_transcripts=exclude))
        got = read_manifest(port[split])
        assert [u.transcript for u in got] == [u.transcript for u in want]
        assert [u.duration for u in got] == [u.duration for u in want]
        assert not exclude & {u.transcript for u in got}
        words = {w for u in got for w in u.transcript.split()}
        assert words <= set(vocab)
        for g, w in zip(got, want):
            with open(g.path, "rb") as fg, open(w.path, "rb") as fw:
                assert fg.read() == fw.read(), g.path


def _narrow(monkeypatch):
    """Presets at test size (``tests/test_torch_ladder.py``)."""
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
def tiny_oov(tmp_path_factory):
    """A tiny r4big (ds2sa and ds3sa), each arm's last checkpoint named as
    at 8000 steps, then ``run_oov`` on it at beam 4, archived."""
    from ctc_asr_tpu_torch.scripts import run_ladder_hard, run_oov
    mp = pytest.MonkeyPatch()
    _narrow(mp)
    mp.setattr(run_oov, "BEAM_WIDTH", 4)
    root = tmp_path_factory.mktemp("oov")
    r4big, out, arch = (str(root / d) for d in ("r4big", "out", "archive"))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            run_ladder_hard.main(["--out", r4big, *TINY_LADDER])
            for arm in ("ds2_specaug", "ds3sa"):
                ckpt = os.path.join(r4big, f"train_{arm}", "ckpt")
                last = sorted(os.listdir(ckpt))[-1]
                shutil.copy(os.path.join(ckpt, last),
                            os.path.join(ckpt, "step_00008000.npz"))
        with contextlib.redirect_stdout(io.StringIO()) as log:
            records = run_oov.main(["--r4big", r4big, "--out", out,
                                    "--archive", arch, *TINY_OOV])
    finally:
        mp.undo()
    return {"r4big": r4big, "out": out, "archive": arch,
            "records": records, "log": log.getvalue()}


def test_tiny_run_writes_the_reference_records(tiny_oov):
    ref = _jsonl(os.path.join(REF, "oov_results.jsonl"))
    assert len(ref) == 19
    assert _shape(tiny_oov["records"]) == _shape(ref)
    assert _jsonl(os.path.join(tiny_oov["archive"],
                               "oov_results.jsonl")) == tiny_oov["records"]
    for r in tiny_oov["records"]:
        if "compare" in r:
            lo, hi = r["ci95"]
            assert lo <= r["wer_delta"] <= hi
            assert r["verdict"] in ("A better", "B better", "tied")
        else:
            assert r["test_wer"] >= 0 and np.isfinite(r["rtf"])


def test_tiny_run_selects_from_the_grids(tiny_oov):
    chosen = []
    for r in tiny_oov["records"]:
        m = re.search(r"\(w=([0-9.]+)\)$|\(a=([0-9.]+)\)$",
                      r.get("decode", ""))
        if m and m.group(1) is not None:
            chosen.append(float(m.group(1)))
            if r["split"] == "oov_test":
                assert chosen[-1] in (0.0, 0.2, 0.4, 0.6)
            else:                 # the settler reuses w=0.4
                assert chosen[-1] == 0.4
        elif m:
            assert float(m.group(2)) in (0.0, 0.3, 0.6, 1.0, 2.0)
            chosen.append(float(m.group(2)))
    assert len(chosen) == 5
    dev_lines = re.findall(r"\[oov ds3sa8000/(?:train|full)lm\] dev sweep "
                           r"(?:lm_weight|rescore_alpha)=", tiny_oov["log"])
    assert len(dev_lines) == 2 * (4 + 5)


def test_tiny_run_writes_the_reference_sidecars(tiny_oov):
    arch = tiny_oov["archive"]
    assert sorted(os.listdir(os.path.join(arch, "per_utt"))) == REF_SIDECARS
    for name in REF_SIDECARS:
        got, ref = _sidecar(arch, name), _sidecar(REF, name)
        assert got["tag"] == ref["tag"] == name[:-len(".json")]
        assert len(got["per_utt"]) == 4
        assert all(len(u) == 4 for u in got["per_utt"])
    # the splits exclude every r4big transcript
    from ctc_asr_tpu_torch.data import read_manifest
    seen = set()
    for split in ("train", "dev", "test"):
        seen |= {u.transcript for u in read_manifest(
            os.path.join(tiny_oov["r4big"], "corpus", f"{split}.csv"))}
    for split in ("bigtest", "oov_dev", "oov_test"):
        man = read_manifest(os.path.join(tiny_oov["out"], f"{split}.csv"))
        assert len(man) == 4 and not seen & {u.transcript for u in man}


def test_runner_refuses_to_run_without_a_gpu(tmp_path, monkeypatch):
    from ctc_asr_tpu_torch.scripts import run_oov
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_oov.main(["--r4big", str(tmp_path), "--out", out])
    assert not os.path.exists(out)


def _pairs(port_dir, ref_dir, name):
    got, ref = _sidecar(port_dir, name), _sidecar(ref_dir, name)
    return ([(u[1], u[3]) for u in got["per_utt"]],
            [(u[1], u[3]) for u in ref["per_utt"]])


def test_h100_oov_archive_has_every_record_of_the_reference():
    ref = _jsonl(os.path.join(REF, "oov_results.jsonl"))
    assert _shape(_jsonl(os.path.join(H100, "oov_results.jsonl"))) == \
        _shape(ref)
    assert sorted(os.listdir(os.path.join(H100, "per_utt"))) == REF_SIDECARS


@pytest.mark.parametrize("name", REF_SIDECARS)
def test_h100_oov_sidecar_has_the_reference_utterances(name):
    got, ref = _pairs(H100, REF, name)
    assert len(got) == (4096 if name.startswith("settler") else 1024)
    assert got == ref


@pytest.mark.parametrize("name", R4BIG_SIDECARS)
def test_h100_r4big_sidecar_has_the_reference_utterances(name):
    got, ref = _pairs(H100_R4BIG, REF_R4BIG, name)
    assert len(got) == 1024
    assert got == ref
    g, r = _sidecar(H100_R4BIG, name), _sidecar(REF_R4BIG, name)
    assert (g["rung"], g["decode"]) == (r["rung"], r["decode"])


def test_h100_r4big_archive_has_both_arms_at_4000_and_8000_steps():
    recs = _jsonl(os.path.join(H100_R4BIG, "ladder_results.jsonl"))
    got = [(r["rung"], re.sub(r"=[0-9.]+", "=", r["decode"]),
            r.get("steps"), bool(r.get("continued"))) for r in recs]
    assert got == [
        ("conv_bilstm3+specaug", "greedy", 4000, False),
        ("deepspeech_beam+specaug", "greedy(diagnostic)", 4000, False),
        ("deepspeech_beam+specaug", "beam64", 4000, False),
        ("deepspeech_beam+specaug+lm_fusion", "beam64+charlm(w=)", None,
         False),
        ("deepspeech_beam+specaug+lm_fusion+rescore",
         "beam64+charlm(w=)+wordlm(a=)", None, False),
        ("conv_bilstm3+specaug", "greedy", 8000, True),
        ("deepspeech_beam+specaug", "greedy", 8000, True),
        ("deepspeech_beam+specaug", "beam64", 8000, True),
        ("deepspeech_beam+specaug+lm_fusion", "beam64+charlm(w=)", 8000,
         True)]
