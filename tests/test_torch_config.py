"""The port's own copies of the JAX-free modules (``config``, ``text``,
``audio``, ``metrics``, ``data``) against the JAX package's originals:
configs serialize byte-identically and cross-load, overrides and their
errors agree, and the copied functions give the same outputs on the
same seeded numpy inputs (exactly: they are the same arithmetic).
"""

import dataclasses
import os

import numpy as np
import pytest

from ctc_asr_tpu import audio as j_audio
from ctc_asr_tpu import config as j_cfg
from ctc_asr_tpu import metrics as j_metrics
from ctc_asr_tpu import text as j_text
from ctc_asr_tpu.data import DataLoader as JLoader
from ctc_asr_tpu.data import manifest as j_manifest
from ctc_asr_tpu.data import native_io as j_native
from ctc_asr_tpu.data import synth as j_synth
from ctc_asr_tpu.data.feature_cache import FEATURE_INT8_SCALE as J_INT8_SCALE
from ctc_asr_tpu.data.feature_cache import feature_key as j_feature_key
from ctc_asr_tpu_torch import audio as t_audio
from ctc_asr_tpu_torch import config as t_cfg
from ctc_asr_tpu_torch import metrics as t_metrics
from ctc_asr_tpu_torch import text as t_text
from ctc_asr_tpu_torch.data import DataLoader as TLoader
from ctc_asr_tpu_torch.data import feature_cache as t_fcache
from ctc_asr_tpu_torch.data import manifest as t_manifest
from ctc_asr_tpu_torch.data import native_io as t_native
from ctc_asr_tpu_torch.data import synth as t_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ["pr1_mfcc_uni", "conv_bilstm3", "deepspeech_beam",
           "lm_fusion_960h", "multihost_dp"]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_json_is_byte_identical_and_cross_loads(name):
    want = j_cfg.to_json(j_cfg.preset(name))
    got = t_cfg.to_json(t_cfg.preset(name))
    assert got == want
    # each package reads the other's file, and the checked-in one
    assert t_cfg.from_json(want) == t_cfg.preset(name)
    assert j_cfg.from_json(got) == j_cfg.preset(name)
    with open(os.path.join(REPO, "configs", name + ".json")) as f:
        checked_in = f.read()
    assert t_cfg.to_json(t_cfg.from_json(checked_in)) == \
        j_cfg.to_json(j_cfg.from_json(checked_in))
    # either package's dataclasses serialize through either to_json
    assert t_cfg.to_json(j_cfg.preset(name)) == want
    assert dataclasses.asdict(t_cfg.preset(name)) == \
        dataclasses.asdict(j_cfg.preset(name))


def test_default_config_and_derived_fields_agree():
    assert t_cfg.to_json(t_cfg.Config()) == j_cfg.to_json(j_cfg.Config())
    for name in PRESETS:
        tf, jf = t_cfg.preset(name).features, j_cfg.preset(name).features
        assert (tf.win_length, tf.hop_length, tf.feature_dim) == \
            (jf.win_length, jf.hop_length, jf.feature_dim)
    assert t_fcache.feature_key(t_cfg.FeatureConfig()) == \
        j_feature_key(j_cfg.FeatureConfig())
    assert t_fcache.FEATURE_INT8_SCALE == J_INT8_SCALE


def test_apply_overrides_and_errors_agree():
    ov = {"train.learning_rate": "3e-4", "model.rnn_layers": "5",
          "model.conv_kernels": "[[5, 11], [3, 5]]",
          "features.use_pallas": "false", "decode.method": "beam",
          "decode.lm_path": "/x/lm.npz", "data.batch_size": 4,
          "model.bidirectional": "true"}
    want = j_cfg.apply_overrides(j_cfg.preset("conv_bilstm3"), ov)
    got = t_cfg.apply_overrides(t_cfg.preset("conv_bilstm3"), ov)
    assert t_cfg.to_json(got) == j_cfg.to_json(want)
    assert got.model.conv_kernels == ((5, 11), (3, 5))
    assert got.features.use_pallas is False and got.data.batch_size == 4
    for bad in ({"train.num_steps": 1}, {"nosuch.key": 1},
                {"model.rnn.units": 1}):
        errs = []
        for mod in (j_cfg, t_cfg):
            with pytest.raises(KeyError) as e:
                mod.apply_overrides(mod.Config(), bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    for mod in (j_cfg, t_cfg):
        with pytest.raises(KeyError, match="unknown preset"):
            mod.preset("nope")
    argv = ["--a.b=1", "--c.d=x=y"]
    assert t_cfg.parse_cli_overrides(argv) == j_cfg.parse_cli_overrides(argv)
    with pytest.raises(ValueError):
        t_cfg.parse_cli_overrides(["positional"])


def test_text_agrees():
    assert (t_text.ALPHABET, t_text.NUM_CLASSES, t_text.BLANK_ID,
            t_text.PAD_ID) == (j_text.ALPHABET, j_text.NUM_CLASSES,
                               j_text.BLANK_ID, j_text.PAD_ID)
    rng = np.random.default_rng(0)
    raw = ["Hello, World! it's 9 o'clock", "  MIXED case; and-dashes ", ""]
    raw += ["".join(rng.choice(list(j_text.ALPHABET + "XYZ.,1"), 30))
            for _ in range(5)]
    for s in raw:
        norm = t_text.normalize_transcript(s)
        assert norm == j_text.normalize_transcript(s)
        np.testing.assert_array_equal(t_text.encode(norm),
                                      j_text.encode(norm))
    texts = [j_text.normalize_transcript(s) for s in raw]
    for max_len in (None, 40):
        got, want = (m.encode_batch(texts, max_len) for m in (t_text, j_text))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    ids = rng.integers(0, j_text.NUM_CLASSES, 50)
    assert t_text.decode_ids(ids) == j_text.decode_ids(ids)


def test_metrics_agree():
    rng = np.random.default_rng(1)
    words = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran"]
    pairs = [(" ".join(rng.choice(words, rng.integers(1, 8))),
              " ".join(rng.choice(words, rng.integers(0, 8))))
             for _ in range(40)]
    accs = []
    for mod in (j_metrics, t_metrics):
        acc = mod.ErrorRateAccumulator()
        for ref, hyp in pairs:
            acc.add(ref, hyp)
        accs.append(acc)
    for ref, hyp in pairs[:10]:
        assert t_metrics.wer(ref, hyp) == j_metrics.wer(ref, hyp)
        assert t_metrics.cer(ref, hyp) == j_metrics.cer(ref, hyp)
        assert t_metrics.levenshtein(ref, hyp) == \
            j_metrics.levenshtein(ref, hyp)
    assert accs[1].summary() == accs[0].summary()
    assert accs[1].bootstrap_ci() == accs[0].bootstrap_ci()
    assert list(accs[1].utt_records) == list(accs[0].utt_records)
    a, b = list(accs[0].utt_records), list(accs[0].utt_records)[::-1]
    assert t_metrics.paired_bootstrap(a, b, n_resamples=200) == \
        j_metrics.paired_bootstrap(a, b, n_resamples=200)


def test_metrics_writer_writes_jsonl_and_events(tmp_path):
    import json
    w = t_metrics.MetricsWriter(str(tmp_path), echo=False)
    w.write(3, loss=1.5, lr=1e-3)
    w.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[0])
    assert rec["step"] == 3 and rec["loss"] == 1.5
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path))
    meter = t_metrics.ThroughputMeter()
    assert meter.audio_seconds_per_second == 0.0
    meter.update(8.0)
    meter.update(8.0)
    assert meter.audio_seconds_per_second > 0


def test_audio_agrees(tmp_path):
    assert (t_audio.ULAW_MU, t_audio.WIRE_SCALE) == \
        (j_audio.ULAW_MU, j_audio.WIRE_SCALE)
    rng = np.random.default_rng(2)
    x = np.clip(rng.standard_normal(4000) * 0.3, -1, 1).astype(np.float32)
    for fn in ("float_to_pcm16", "float_to_wire16", "float_to_ulaw"):
        np.testing.assert_array_equal(getattr(t_audio, fn)(x),
                                      getattr(j_audio, fn)(x))
    wire = j_audio.float_to_ulaw(x)
    np.testing.assert_array_equal(t_audio.ulaw_to_float(wire),
                                  j_audio.ulaw_to_float(wire))
    np.testing.assert_array_equal(t_audio.resample(x, 8000, 16000),
                                  j_audio.resample(x, 8000, 16000))
    path = str(tmp_path / "a.wav")
    t_audio.write_wav(path, x, 8000)
    got, sr = t_audio.read_wav(path, 16000)
    want, jsr = j_audio.read_wav(path, 16000)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)
    assert t_audio.duration_seconds(path) == j_audio.duration_seconds(path)


def test_synth_corpus_manifest_and_loader_agree(tmp_path):
    for fn, args in (("render_transcript", ("hi there",)),
                     ("char_frequencies", ("q",)),
                     ("build_vocabulary", (40,))):
        got, want = getattr(t_synth, fn)(*args), getattr(j_synth, fn)(*args)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want
    tm = t_synth.generate_corpus(str(tmp_path / "t"), num_utterances=5,
                                 seed=4)
    jm = j_synth.generate_corpus(str(tmp_path / "j"), num_utterances=5,
                                 seed=4)
    t_utts, j_utts = t_manifest.read_manifest(tm), j_manifest.read_manifest(jm)
    assert [(u.duration, u.transcript) for u in t_utts] == \
        [(u.duration, u.transcript) for u in j_utts]
    for a, b in zip(t_utts, j_utts):
        np.testing.assert_array_equal(t_audio.read_wav(a.path)[0],
                                      j_audio.read_wav(b.path)[0])
    # either package's reader takes either's manifest; the loaders plan
    # and pad the same batches
    assert len(j_manifest.read_manifest(tm)) == len(t_utts)
    dcfg = dict(batch_size=2, num_buckets=1, num_workers=1)
    tl = TLoader(t_utts, t_cfg.DataConfig(**dcfg), t_cfg.FeatureConfig(),
                 drop_last=False)
    jl = JLoader(j_manifest.read_manifest(tm), j_cfg.DataConfig(**dcfg),
                 j_cfg.FeatureConfig(), drop_last=False)
    n = 0
    for tb, jb in zip(tl.iter_epoch(0), jl.iter_epoch(0)):
        np.testing.assert_array_equal(tb.samples, jb.samples)
        np.testing.assert_array_equal(tb.sample_lengths, jb.sample_lengths)
        np.testing.assert_array_equal(tb.labels, jb.labels)
        assert tb.transcripts == jb.transcripts and tb.valid == jb.valid
        n += 1
    assert n == 3


def test_native_io_points_at_the_same_library():
    """The copy finds ``native/`` at the repository root, like the
    original: the shared library is not duplicated."""
    assert t_native._SO_PATH == j_native._SO_PATH
    assert t_native._NATIVE_DIR == os.path.join(REPO, "native")
