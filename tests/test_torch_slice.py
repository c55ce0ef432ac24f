"""The port's serving and decode slices on the CPU: greedy decode,
checkpoint reading, evaluate / Transcriber / CLI against the JAX
reference with greedy, beam, char-LM fusion and word-LM rescoring, the
no-JAX import rule, and the refusal to fall back from CUDA to the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctc_asr_tpu.checkpoint import _flatten, save_checkpoint
from ctc_asr_tpu.config import Config, DataConfig, FeatureConfig, ModelConfig
from ctc_asr_tpu.data.synth import generate_corpus
from ctc_asr_tpu.ops.greedy import greedy_decode as j_greedy
from ctc_asr_tpu.text import BLANK_ID
from ctc_asr_tpu.train import init_train_state
from ctc_asr_tpu_torch import checkpoint as t_ckpt
from ctc_asr_tpu_torch.ops.dispatch import resolve_device
from ctc_asr_tpu_torch.ops.greedy import greedy_decode
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_ids_identical(seed):
    """Logits drawn from a few levels, so argmax ties and repeats occur;
    lengths include 0 and the full T."""
    rng = np.random.default_rng(seed)
    B, T, C = 5, 17, 29
    logits = rng.integers(0, 3, (B, T, C)).astype(np.float32)
    logits[:, ::3, BLANK_ID] += 5.0
    lens = np.array([17, 0, 1, 9, 16], np.int32)
    want_ids, want_lens = j_greedy(jnp.asarray(logits), jnp.asarray(lens))
    ids, dlens = greedy_decode(torch.from_numpy(logits),
                               torch.from_numpy(lens))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(dlens.numpy(), np.asarray(want_lens))


def _tiny_cfg(manifest="") -> Config:
    """A tiny f32 conv + BiLSTM config. The reference runs its plain
    paths on the CPU whatever its use_pallas flags say; the port takes
    the flags as given, so they are off here to compare like with like."""
    return Config(
        features=FeatureConfig(n_mels=40, use_pallas=False),
        model=ModelConfig(frontend="conv", conv_channels=(4, 4),
                          conv_kernels=((5, 11), (3, 5)), rnn_layers=2,
                          rnn_units=16, bidirectional=True, dropout=0.0,
                          compute_dtype="float32", use_pallas_rnn=False),
        data=DataConfig(eval_manifest=manifest, batch_size=2, num_buckets=1,
                        num_workers=1))


def test_reads_reference_checkpoint(tmp_path):
    cfg = _tiny_cfg()
    state = init_train_state(cfg)
    path = save_checkpoint(str(tmp_path / "ckpt"), 7, state,
                           process_index=0)
    params = t_ckpt.load_params(str(tmp_path), cfg)        # train dir
    assert t_ckpt.resolve_checkpoint(str(tmp_path)) == path
    want = _flatten(state["params"])
    assert set(params) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(params[k].numpy(), v)
    with np.load(path) as z:                               # opt_state etc.
        assert any(k.startswith("opt_state/") for k in z.files)
        assert set(t_ckpt.params_from_jax(dict(z))) == set(want)
    wrong = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, rnn_units=8))
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.load_params(path, wrong)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    manifest = generate_corpus(str(d), num_utterances=4, seed=3)
    cfg = _tiny_cfg(manifest)
    state = init_train_state(cfg)
    path = save_checkpoint(str(d / "ckpt"), 1, state, process_index=0)
    return cfg, state["params"], path


def test_evaluate_and_transcribe_match_reference(corpus):
    from ctc_asr_tpu.evaluate import evaluate as j_evaluate
    from ctc_asr_tpu.transcribe import Transcriber as JTranscriber
    from ctc_asr_tpu_torch.evaluate import evaluate
    from ctc_asr_tpu_torch.transcribe import Transcriber
    cfg, jparams, path = corpus
    params = t_ckpt.load_params(path, cfg)
    want = j_evaluate(cfg, jparams, log_samples=0)
    got = evaluate(cfg, params, "cpu", log_samples=0)
    assert got["per_utt"] == want["per_utt"]
    assert got["utterances"] == want["utterances"] >= 3
    assert got["device"] == "cpu"
    for k in ("wer", "cer", "audio_seconds"):
        assert got[k] == want[k]
    jtr, ttr = JTranscriber(cfg, jparams), Transcriber(cfg, params, "cpu")
    from ctc_asr_tpu.data import read_manifest
    for utt in read_manifest(cfg.data.eval_manifest):
        assert ttr.transcribe_file(utt.path) == jtr.transcribe_file(utt.path)


def test_evaluate_uploads_ahead_through_device_batches(corpus, monkeypatch):
    """``evaluate`` draws its batches through ``train.device_batches(...,
    with_labels=False)`` (the next batch's upload in flight while this one
    computes), ``max_batches`` caps the loader before that prefetch, and
    the transcripts and ``per_utt`` are those of a loop that feeds each
    loader batch straight to the step, in the same order."""
    from ctc_asr_tpu_torch import evaluate as ev_mod
    from ctc_asr_tpu_torch import train as tr_mod
    from ctc_asr_tpu_torch.data import DataLoader, read_manifest
    from ctc_asr_tpu_torch.metrics import ErrorRateAccumulator
    from ctc_asr_tpu_torch.text import decode_ids
    cfg, _, path = corpus
    params = t_ckpt.load_params(path, cfg)
    switches, pulled, hyps = [], [], []

    def spy(src, loader, dev, with_labels=True):
        switches.append(with_labels)

        def counted():
            for b in src:
                pulled.append(b.position)
                yield b
        for b, arrs in tr_mod.device_batches(counted(), loader, dev,
                                             with_labels):
            assert len(arrs) == 2 and all(torch.is_tensor(a) for a in arrs)
            yield b, arrs

    def record(ids):
        hyps.append(decode_ids(ids))
        return hyps[-1]
    monkeypatch.setattr(ev_mod, "device_batches", spy)
    monkeypatch.setattr(ev_mod, "decode_ids", record)
    got = ev_mod.evaluate(cfg, params, "cpu", log_samples=0)
    assert switches == [False] and len(pulled) == 2

    step = ev_mod.make_eval_step(cfg, "cpu")
    decoder = ev_mod.make_decoder(cfg)
    acc, want_hyps = ErrorRateAccumulator(), []
    loader = DataLoader(read_manifest(cfg.data.eval_manifest), cfg.data,
                        cfg.features, drop_last=False)
    for batch in loader.iter_epoch(0):
        ids, lens = decoder(*step(params, batch.samples,
                                  batch.sample_lengths))
        for i in range(batch.valid):
            want_hyps.append(decode_ids(ids[i, :lens[i]].numpy()))
            acc.add(batch.transcripts[i], want_hyps[-1])
    assert hyps == want_hyps
    assert got["per_utt"] == list(acc.utt_records)

    pulled.clear()
    hyps.clear()
    one = ev_mod.evaluate(cfg, params, "cpu", max_batches=1, log_samples=0)
    assert len(pulled) == 1                  # nothing read past the cap
    assert hyps == want_hyps[:len(hyps)] and len(hyps) == one["utterances"]
    assert one["per_utt"] == got["per_utt"][:len(hyps)]


def test_cli_evaluate_and_transcribe(corpus, tmp_path, capsys):
    from ctc_asr_tpu.data import read_manifest
    from ctc_asr_tpu_torch import cli
    cfg, _, path = corpus
    cfg_path = tmp_path / "cfg.json"
    from ctc_asr_tpu.config import to_json
    cfg_path.write_text(to_json(cfg))
    dump = tmp_path / "utts.json"
    assert cli.main(["evaluate", "--config", str(cfg_path), "--ckpt", path,
                     "--device=cpu", f"--dump-utts={dump}",
                     "--model.use_pallas_rnn=true"]) == 0
    out = capsys.readouterr().out
    res = json.loads(out[out.index("\n{") + 1:])
    assert res["utterances"] >= 3 and "rtf" in res
    assert len(json.loads(dump.read_text())["per_utt"]) == res["utterances"]
    wav = read_manifest(cfg.data.eval_manifest)[0].path
    assert cli.main(["transcribe", "--config", str(cfg_path), "--ckpt",
                     path, "--device=cpu", wav]) == 0
    assert capsys.readouterr().out.startswith(f"{wav}\t")
    beam = ["--decode.method=beam", "--decode.beam_width=4"]
    assert cli.main(["evaluate", "--config", str(cfg_path), "--ckpt", path,
                     "--device=cpu", *beam]) == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("\n{") + 1:])["utterances"] \
        == res["utterances"]
    assert cli.main(["transcribe", "--config", str(cfg_path), "--ckpt",
                     path, "--device=cpu", *beam, wav]) == 0
    assert capsys.readouterr().out.startswith(f"{wav}\t")


def test_reads_ds3_geometry_checkpoint(tmp_path):
    """5 x BiLSTM as in ``deepspeech_beam`` / ``lm_fusion_960h``: narrow
    weights round-trip, and at the presets' full width (800 units) the
    port expects exactly the reference's keys and shapes."""
    import jax
    from ctc_asr_tpu.config import preset
    from ctc_asr_tpu_torch.models import init_shapes
    base = _tiny_cfg()
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, rnn_layers=5, rnn_units=8))
    state = init_train_state(cfg)
    path = save_checkpoint(str(tmp_path / "ckpt"), 3, state, process_index=0)
    params = t_ckpt.load_params(path, cfg)
    want = _flatten(state["params"])
    assert set(params) == set(want) and len(
        [k for k in want if k.startswith("rnn/")]) >= 5 * 2 * 2
    for k, v in want.items():
        np.testing.assert_array_equal(params[k].numpy(), v)
    for name in ("deepspeech_beam", "lm_fusion_960h"):
        full = preset(name)
        shapes = jax.eval_shape(lambda: init_train_state(full)["params"])
        want_shapes = {
            "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in kp): tuple(leaf.shape)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        assert {k: tuple(s) for k, s in init_shapes(
            full.model, full.features.feature_dim).items()} == want_shapes
        assert any(s[-1] == 3200 for s in want_shapes.values())


@pytest.fixture(scope="module")
def lms(corpus, tmp_path_factory):
    """A char LM (order 3) and a word LM (order 2) trained by the port's
    CLI from the corpus's manifest."""
    from ctc_asr_tpu_torch import cli
    cfg, _, _ = corpus
    d = tmp_path_factory.mktemp("lms")
    char_lm, word_lm = str(d / "char.npz"), str(d / "word.pkl")
    assert cli.main(["train-lm", "--manifest", cfg.data.eval_manifest,
                     "--out", char_lm, "--order", "3"]) == 0
    assert cli.main(["train-lm", "--manifest", cfg.data.eval_manifest,
                     "--out", word_lm, "--order", "2", "--words"]) == 0
    return char_lm, word_lm


def _hyps(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[eval] hyp:")]


@pytest.mark.parametrize("mode", ["beam", "fusion", "rescoring",
                                  "kernel_flag"])
def test_beam_slice_matches_reference(corpus, lms, capsys, mode):
    """The decode slice as a whole, conv + 2 x BiLSTM, through both
    packages' ``evaluate``: identical transcripts, per-utterance error
    counts and WER. The reference runs its XLA beam search on the CPU
    whatever ``decode.use_pallas`` says; the port's flag picks the
    wrapper, which on a CPU tensor is the plain version too."""
    from ctc_asr_tpu.evaluate import evaluate as j_evaluate
    from ctc_asr_tpu.transcribe import Transcriber as JTranscriber
    from ctc_asr_tpu_torch.evaluate import evaluate
    from ctc_asr_tpu_torch.transcribe import Transcriber
    cfg, jparams, path = corpus
    char_lm, word_lm = lms
    decode = dict(method="beam", beam_width=8, nbest=4, use_pallas=False)
    if mode != "beam":
        decode.update(lm_path=char_lm, lm_weight=0.8, word_bonus=1.0)
    if mode == "rescoring":
        decode.update(word_lm_path=word_lm, rescore_alpha=0.9,
                      rescore_beta=0.2)
    if mode == "kernel_flag":
        decode.update(use_pallas=True)
    cfg = dataclasses.replace(cfg, decode=dataclasses.replace(
        cfg.decode, **decode))
    params = t_ckpt.load_params(path, cfg)
    want = j_evaluate(cfg, jparams, log_samples=10)
    want_hyps = _hyps(capsys)
    got = evaluate(cfg, params, "cpu", log_samples=10)
    got_hyps = _hyps(capsys)
    assert got_hyps == want_hyps and len(got_hyps) == got["utterances"] >= 3
    assert got["per_utt"] == want["per_utt"]
    assert got["wer"] == want["wer"] and got["cer"] == want["cer"]
    from ctc_asr_tpu.data import read_manifest
    jtr, ttr = JTranscriber(cfg, jparams), Transcriber(cfg, params, "cpu")
    for utt in read_manifest(cfg.data.eval_manifest)[:2]:
        assert ttr.transcribe_file(utt.path) == jtr.transcribe_file(utt.path)


@pytest.mark.parametrize("rnn_type", ["gru", "rnn"])
def test_gru_and_vanilla_slice_matches_reference(corpus, tmp_path, capsys,
                                                 rnn_type):
    """The GRU / vanilla-RNN family end to end: a checkpoint written by
    the reference is read by the port (``params_from_jax``: same
    keypaths, 3H or H gate columns), both packages' ``evaluate`` and
    ``Transcriber`` give identical transcripts from it, and the port's
    own checkpoint of that state loads back into the reference."""
    from ctc_asr_tpu.checkpoint import load_checkpoint
    from ctc_asr_tpu.data import read_manifest
    from ctc_asr_tpu.evaluate import evaluate as j_evaluate
    from ctc_asr_tpu.transcribe import Transcriber as JTranscriber
    from ctc_asr_tpu_torch import train as t_train
    from ctc_asr_tpu_torch.evaluate import evaluate
    from ctc_asr_tpu_torch.transcribe import Transcriber
    base, _, _ = corpus
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, rnn_type=rnn_type))
    state = init_train_state(cfg)
    path = save_checkpoint(str(tmp_path / "ckpt"), 2, state, process_index=0)
    params = t_ckpt.load_params(path, cfg)
    want_flat = _flatten(state["params"])
    assert set(params) == set(want_flat)
    G = {"gru": 3, "rnn": 1}[rnn_type] * cfg.model.rnn_units
    assert params["rnn/1/bwd/wh"].shape == (cfg.model.rnn_units, G)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(params[k].numpy(), v)
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.load_params(path, base)                  # an LSTM config

    want = j_evaluate(cfg, state["params"], log_samples=10)
    want_hyps = _hyps(capsys)
    got = evaluate(cfg, params, "cpu", log_samples=10)
    assert _hyps(capsys) == want_hyps and len(want_hyps) >= 3
    assert got["per_utt"] == want["per_utt"] and got["wer"] == want["wer"]
    jtr = JTranscriber(cfg, state["params"])
    ttr = Transcriber(cfg, params, "cpu")
    for utt in read_manifest(cfg.data.eval_manifest)[:2]:
        assert ttr.transcribe_file(utt.path) == jtr.transcribe_file(utt.path)

    # and back: the port's checkpoint of this state, read by the reference
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tstate = t_train.state_from_parts(
        cfg, *t_ckpt.state_from_flat(flat, cfg), torch.device("cpu"))
    back = t_ckpt.save_checkpoint(str(tmp_path / "back"), 2,
                                  t_train.state_to_flat(cfg, tstate))
    jstate, _ = load_checkpoint(back, init_train_state(cfg))
    for k, v in _flatten(jstate["params"]).items():
        np.testing.assert_array_equal(v, want_flat[k], err_msg=k)
    assert int(jstate["step"]) == int(state["step"])


def test_cli_compare_and_prepare_synth(tmp_path, capsys):
    from ctc_asr_tpu_torch import cli
    from ctc_asr_tpu_torch.data import read_manifest
    assert cli.main(["prepare-synth", "--out", str(tmp_path / "s"), "--n",
                     "3", "--seed", "5"]) == 0
    manifest = capsys.readouterr().out.strip()
    want = generate_corpus(str(tmp_path / "ref"), num_utterances=3, seed=5)
    assert [u.transcript for u in read_manifest(manifest)] == \
        [u.transcript for u in read_manifest(want)]
    a = [(1, 4, 2, 20), (0, 3, 0, 15), (2, 5, 4, 22)] * 4
    b = [(0, 4, 0, 20), (0, 3, 0, 15), (1, 5, 1, 22)] * 4
    for name, recs in (("a.json", a), ("b.json", b)):
        (tmp_path / name).write_text(json.dumps({"per_utt": recs}))
    assert cli.main(["compare", str(tmp_path / "a.json"),
                     str(tmp_path / "b.json"), "--resamples", "200"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out[:out.index("\n#")])["wer_delta"] > 0
    assert "# B better" in out


def test_import_leaves_jax_out():
    code = ("import sys, ctc_asr_tpu_torch, ctc_asr_tpu_torch.cli, "
            "ctc_asr_tpu_torch.evaluate, ctc_asr_tpu_torch.transcribe, "
            "ctc_asr_tpu_torch.ops.stft_cuda, ctc_asr_tpu_torch.ops.lstm_cuda,"
            "ctc_asr_tpu_torch.ops.gru_cuda, ctc_asr_tpu_torch.data.generate,"
            "ctc_asr_tpu_torch.utils.profiling, "
            "ctc_asr_tpu_torch.ops.ctc_cuda, ctc_asr_tpu_torch.train, "
            "ctc_asr_tpu_torch.ops.beam_cuda, ctc_asr_tpu_torch.ops.lm, "
            "ctc_asr_tpu_torch.optim, ctc_asr_tpu_torch.checkpoint;"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_cuda_request_raises_without_gpu(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ctc_asr_tpu_torch.evaluate import make_eval_step
    from ctc_asr_tpu_torch.transcribe import Transcriber
    cfg, _, path = corpus
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(cfg, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Transcriber(cfg, t_ckpt.load_params(path, cfg), "cuda")
    assert resolve_device("cpu") == torch.device("cpu")
