"""The port's data tools on the CPU, held against the JAX reference:
``compute-stats``, the feature cache's write side (``prepare-features``),
the corpus generators (``prepare-librispeech``, ``prepare-corpus``,
``prepare-synth-hard``) and training / evaluating from a cache.

The files are the interface: a stats npz or a cache directory written by
either package must load in the other, and ``index.json``'s
``feature_key`` must be byte-equal for the same config. Tolerances:

- stats: both accumulate f32 sums per batch and divide in f64; the
  features themselves agree to ~1e-5 of their scale (log-mel values of
  magnitude ~10), so mean and var are held to rtol 1e-5 / atol 1e-4.
- f16 cache: the two packages' f32 features differ in the last bits, so
  a value near an f16 rounding boundary may land on the neighbouring
  f16: at most one f16 ulp, 2**-10 of the value (2**-14 near zero).
- int8 cache: ``rint(x * 16)``, at most one level apart.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ctc_asr_tpu import features as j_feat
from ctc_asr_tpu.config import (Config, DataConfig, FeatureConfig,
                                ModelConfig, TrainConfig, to_json)
from ctc_asr_tpu.data import feature_cache as j_fc
from ctc_asr_tpu.data import generate as j_gen
from ctc_asr_tpu.data.synth import generate_corpus
from ctc_asr_tpu_torch import audio as audio_mod
from ctc_asr_tpu_torch import cli
from ctc_asr_tpu_torch import features as t_feat
from ctc_asr_tpu_torch.data import DataLoader, read_manifest
from ctc_asr_tpu_torch.data import feature_cache as t_fc
from ctc_asr_tpu_torch.data import generate as t_gen
from torch_threads import one_thread  # noqa: F401  (autouse)

DATA_CFG = DataConfig(batch_size=4, num_buckets=2, num_workers=1,
                      min_audio_seconds=0.1, max_audio_seconds=10.0)
FEAT_CFG = FeatureConfig(n_mels=40, use_pallas=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("dt_corpus")
    return generate_corpus(str(out), num_utterances=10, seed=2)


@pytest.fixture(scope="module")
def stats(corpus, tmp_path_factory):
    """(port npz, reference npz) of compute-stats over the corpus."""
    d = tmp_path_factory.mktemp("stats")
    tp, jp = str(d / "torch.npz"), str(d / "jax.npz")
    man = read_manifest(corpus)
    t_feat.compute_dataset_stats(man, DATA_CFG, FEAT_CFG, tp, device="cpu")
    j_feat.compute_dataset_stats(man, DATA_CFG, FEAT_CFG, jp)
    return tp, jp


def test_compute_stats_matches_reference(stats):
    tp, jp = stats
    with np.load(tp) as t, np.load(jp) as j:
        assert sorted(t.files) == sorted(j.files) == ["frames", "mean", "var"]
        assert float(t["frames"]) == float(j["frames"]) > 0
        for k in ("mean", "var"):
            assert t[k].dtype == j[k].dtype == np.float32
            assert t[k].shape == (FEAT_CFG.feature_dim,)
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-4)
    # each package reads the other's file
    for a, b in zip(t_feat._load_stats(jp), j_feat._load_stats(tp)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def test_compute_stats_max_batches_and_cli(corpus, tmp_path, capsys):
    man = read_manifest(corpus)
    one = t_feat.compute_dataset_stats(man, DATA_CFG, FEAT_CFG,
                                       str(tmp_path / "one.npz"),
                                       max_batches=1, device="cpu")
    ref = j_feat.compute_dataset_stats(man, DATA_CFG, FEAT_CFG,
                                       str(tmp_path / "ref.npz"),
                                       max_batches=1)
    assert one["frames"] == ref["frames"]
    out = tmp_path / "cli.npz"
    assert cli.main(["compute-stats", "--manifest", corpus, "--out",
                     str(out), "--device=cpu", "--features.n_mels=40",
                     "--features.use_pallas=false", "--data.batch_size=4",
                     "--data.num_buckets=2", "--data.num_workers=1",
                     "--data.min_audio_seconds=0.1"]) == 0
    assert "frames)" in capsys.readouterr().out
    with np.load(out) as z:
        assert z["mean"].shape == (40,) and float(z["frames"]) > one["frames"]


def _build_both(corpus, feat_cfg, root, dtype):
    man = read_manifest(corpus)
    td, jd = os.path.join(root, "torch_" + dtype), os.path.join(
        root, "jax_" + dtype)
    t_fc.build_feature_cache(man, DATA_CFG, feat_cfg, td, progress_every=0,
                             dtype=dtype, device="cpu")
    j_fc.build_feature_cache(man, DATA_CFG, feat_cfg, jd, progress_every=0,
                             dtype=dtype)
    return man, td, jd


@pytest.mark.parametrize("dtype", ["float16", "int8"])
@pytest.mark.parametrize("normalization", ["utterance", "global"])
def test_feature_cache_matches_reference(corpus, stats, tmp_path, dtype,
                                         normalization):
    fc = dataclasses.replace(FEAT_CFG, normalization=normalization,
                             stats_path=stats[0]
                             if normalization == "global" else "")
    man, td, jd = _build_both(corpus, fc, str(tmp_path), dtype)
    with open(os.path.join(td, "index.json")) as f:
        tidx = json.load(f)
    with open(os.path.join(jd, "index.json")) as f:
        jidx = json.load(f)
    assert tidx["feature_key"] == jidx["feature_key"] == t_fc.feature_key(fc)
    assert tidx == jidx                 # dim, dtype, scale, every entry
    assert len(tidx["entries"]) == len(man)
    # each package's reader takes the other's cache
    for reader, d in ((t_fc.FeatureCache, jd), (j_fc.FeatureCache, td)):
        assert reader(d, fc).dtype == dtype
    got, want = t_fc.FeatureCache(td, fc), j_fc.FeatureCache(jd, fc)
    for u in man:
        a, b = got.read(u.path), want.read(u.path)
        assert a.dtype == b.dtype and a.shape == b.shape and len(a) > 0
        if dtype == "int8":
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            a32, b32 = a.astype(np.float32), b.astype(np.float32)
            ulp = np.maximum(np.abs(b32) * 2.0 ** -10, 2.0 ** -14)
            assert (np.abs(a32 - b32) <= ulp).all()
    # and against the port's own on-the-fly pipeline
    u = man[0]
    s, _ = audio_mod.read_wav(u.path, fc.sample_rate)
    feats, flens = t_feat.extract_features(
        torch.from_numpy(s[None]), torch.tensor([len(s)]), fc)
    ref = feats[0, :int(flens[0])].numpy()
    a = got.read(u.path).astype(np.float32)
    if dtype == "int8":
        np.testing.assert_allclose(a / t_fc.FEATURE_INT8_SCALE, ref,
                                   atol=0.6 / t_fc.FEATURE_INT8_SCALE)
    else:
        np.testing.assert_allclose(a, ref, atol=2e-3, rtol=2e-3)


def test_feature_key_tracks_the_stats_file(stats, tmp_path):
    tp, jp = stats
    fc = dataclasses.replace(FEAT_CFG, normalization="global", stats_path=tp)
    assert t_fc.feature_key(fc) == j_fc.feature_key(fc)
    assert "stats_sha1" in t_fc.feature_key(fc)
    moved = str(tmp_path / "s.npz")
    with open(jp, "rb") as f, open(moved, "wb") as g:
        g.write(f.read())
    k1 = t_fc.feature_key(dataclasses.replace(fc, stats_path=moved))
    with np.load(tp) as z:
        np.savez(moved, mean=z["mean"] + 1, var=z["var"], frames=z["frames"])
    k2 = t_fc.feature_key(dataclasses.replace(fc, stats_path=moved))
    assert k1 != k2                       # same path, new contents


def test_stale_and_uncacheable_configs_are_refused(corpus, tmp_path):
    man = read_manifest(corpus)
    out = str(tmp_path / "cache")
    t_fc.build_feature_cache(man, DATA_CFG, FEAT_CFG, out, progress_every=0,
                             device="cpu")
    other = dataclasses.replace(FEAT_CFG, n_mels=26)
    for reader in (t_fc.FeatureCache, j_fc.FeatureCache):
        with pytest.raises(ValueError, match="different FeatureConfig"):
            reader(out, other)
    assert t_fc.feature_key(dataclasses.replace(FEAT_CFG, use_pallas=True)) \
        == t_fc.feature_key(FEAT_CFG)
    glob = dataclasses.replace(FEAT_CFG, normalization="global")
    with pytest.raises(ValueError, match="stats_path"):
        t_fc.build_feature_cache(man, DATA_CFG, glob, str(tmp_path / "c"),
                                 device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        t_fc.build_feature_cache(man, DATA_CFG, FEAT_CFG,
                                 str(tmp_path / "c"), dtype="float32",
                                 device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_fc.build_feature_cache(man, DATA_CFG, FEAT_CFG,
                                     str(tmp_path / "c"))


def test_build_ignores_length_filters(corpus, tmp_path):
    man = read_manifest(corpus)
    durations = [u.duration for u in man]
    tight = dataclasses.replace(
        DATA_CFG, min_audio_seconds=min(durations) + 1e-4,
        max_audio_seconds=max(durations) - 1e-4)
    out = str(tmp_path / "cache")
    t_fc.build_feature_cache(man, tight, FEAT_CFG, out, progress_every=0,
                             device="cpu")
    cache = t_fc.FeatureCache(out, FEAT_CFG)
    assert all(u.path in cache for u in man)


def _tiny_cfg(corpus, train_dir, rnn_type="gru", **data) -> Config:
    return Config(
        features=FEAT_CFG,
        model=ModelConfig(frontend="conv", conv_channels=(4, 4),
                          conv_kernels=((5, 11), (3, 5)), rnn_layers=1,
                          rnn_units=16, bidirectional=True, dropout=0.0,
                          compute_dtype="float32", use_pallas_rnn=False,
                          rnn_type=rnn_type),
        data=dataclasses.replace(DATA_CFG, train_manifest=corpus,
                                 eval_manifest=corpus, **data),
        train=TrainConfig(learning_rate=1e-3, log_every=1, sync_every=1,
                          checkpoint_every=0, train_dir=train_dir))


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["loss"] for r in recs if "loss" in r]


def _eval_json(out):
    return json.loads(out[out.index("\n{") + 1:])


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_cli_train_and_evaluate_from_a_cache(corpus, tmp_path, capsys, dtype):
    """``prepare-features`` -> ``train`` / ``evaluate`` with
    ``--data.feature_cache``: the loader ships cached features (no DSP in
    the step); the first step's loss is the wav run's within the cache's
    rounding, and evaluating one checkpoint from the cache and from wavs
    counts the same utterances."""
    cache = str(tmp_path / "cache")
    cfg = _tiny_cfg(corpus, str(tmp_path / "wav_run"))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(to_json(cfg))
    assert cli.main(["prepare-features", "--config", str(cfg_path),
                     "--manifest", corpus, "--out", cache, "--dtype", dtype,
                     "--device=cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith(cache)
    loader = DataLoader(read_manifest(corpus), dataclasses.replace(
        cfg.data, feature_cache=cache), cfg.features)
    batch = next(loader.iter_epoch(0))
    assert batch.samples.ndim == 3 and batch.samples.dtype == np.dtype(dtype)

    base = ["train", "--config", str(cfg_path), "--device=cpu",
            "--max-steps=3"]
    assert cli.main(base) == 0
    cached_dir = str(tmp_path / "cache_run")
    assert cli.main(base + [f"--data.feature_cache={cache}",
                            f"--train.train_dir={cached_dir}"]) == 0
    capsys.readouterr()
    wav_loss, cache_loss = _losses(cfg.train.train_dir), _losses(cached_dir)
    assert len(cache_loss) == 3 and np.isfinite(cache_loss).all()
    rtol = 2e-3 if dtype == "float16" else 5e-2
    np.testing.assert_allclose(cache_loss[0], wav_loss[0], rtol=rtol)

    ev = ["evaluate", "--config", str(cfg_path), "--ckpt",
          cfg.train.train_dir, "--device=cpu"]
    assert cli.main(ev) == 0
    from_wav = _eval_json(capsys.readouterr().out)
    assert cli.main(ev + [f"--data.feature_cache={cache}"]) == 0
    from_cache = _eval_json(capsys.readouterr().out)
    assert from_cache["utterances"] == from_wav["utterances"] > 0
    assert from_cache["audio_seconds"] == from_wav["audio_seconds"]
    assert np.isfinite(from_cache["wer"])


# ---------------------------------------------------------------------------
# corpus generators: fake corpus trees with .wav inputs (no ffmpeg / sox)
# ---------------------------------------------------------------------------

def _wav(path, seconds, sr=16000, seed=0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    audio_mod.write_wav(
        path, (rng.standard_normal(int(seconds * sr)) * 0.1)
        .astype(np.float32), sr)


def _librispeech(root):
    chap = root / "dev-mini" / "84" / "121123"
    _wav(str(chap / "84-121123-0000.wav"), 1.5)
    _wav(str(chap / "84-121123-0001.wav"), 0.8)
    (chap / "84-121123.trans.txt").write_text(
        "84-121123-0000 HELLO, World!\n84-121123-0001 IT'S A TEST\n")


def _common_voice(root):
    _wav(str(root / "clips" / "a1.wav"), 1.0)
    _wav(str(root / "clips" / "a2.wav"), 0.5)
    (root / "validated.tsv").write_text(
        "client_id\tpath\tsentence\nx\ta1.wav\tFirst Sentence\n"
        "y\ta2.wav\tSecond one\nz\tmissing.wav\tskipped row\n")


def _timit(root):
    d = root / "TRAIN" / "DR1" / "FABC0"
    _wav(str(d / "SI1234.wav"), 0.6)
    (d / "SI1234.TXT").write_text("0 9600 She washed dishes.\n")
    _wav(str(d / "SA1.wav"), 0.6)                  # SA* are skipped
    (d / "SA1.TXT").write_text("0 9600 skip me\n")


def _tatoeba(root):
    _wav(str(root / "audio" / "101.wav"), 0.4)
    _wav(str(root / "audio" / "102.wav"), 0.9)
    (root / "sentences.csv").write_text(
        "101\teng\tGood morning\n102\teng\tSee you later\n"
        "103\tdeu\tGuten Morgen\n")


def _tedlium(root, outs):
    (root / "train" / "stm").mkdir(parents=True)
    (root / "train" / "stm" / "TalkA.stm").write_text(
        "TalkA 1 spk 0.50 1.20 <o> hello world\n;; comment line\n"
        "TalkA 1 spk 1.80 2.70 <o> second segment here\n")
    for out in outs:      # the converted talk, where prepare_tedlium looks
        _wav(str(out / "train" / "wav" / "TalkA.wav"), 3.0)


_CORPORA = {
    "librispeech": (_librispeech, "prepare_librispeech",
                    ["it's a test", "hello world"]),
    "common_voice": (_common_voice, "prepare_common_voice",
                     ["second one", "first sentence"]),
    "timit": (_timit, "prepare_timit", ["she washed dishes"]),
    "tatoeba": (_tatoeba, "prepare_tatoeba",
                ["good morning", "see you later"]),
    "tedlium": (_tedlium, "prepare_tedlium",
                ["hello world", "second segment here"]),
}


def _rows(path):
    """(file name, duration, transcript) rows of a manifest."""
    return [(os.path.basename(u.path), u.duration, u.transcript)
            for u in read_manifest(path)]


@pytest.mark.parametrize("name", sorted(_CORPORA))
def test_generators_match_reference(tmp_path, name):
    make, fn, texts = _CORPORA[name]
    root, t_out, j_out = (tmp_path / "root", tmp_path / "t_out",
                          tmp_path / "j_out")
    if name == "tedlium":
        make(root, (t_out, j_out))
    else:
        make(root)
    got = getattr(t_gen, fn)(str(root), str(t_out))
    want = getattr(j_gen, fn)(str(root), str(j_out))
    if name == "librispeech":
        assert len(got) == len(want) == 1
        got, want = got[0], want[0]
    assert os.path.basename(got) == os.path.basename(want)
    assert _rows(got) == _rows(want)
    rows = _rows(got)
    assert [r[2] for r in rows] == texts          # sorted by duration
    assert [r[1] for r in rows] == sorted(r[1] for r in rows)
    for u in read_manifest(got):
        assert os.path.exists(u.path) and u.path.endswith(".wav")


def test_parse_stm_and_convert_audio(tmp_path):
    line = "TalkA 1 spk1 12.50 15.75 <o,f0,male> hello there world"
    assert t_gen.parse_stm_line(line) == j_gen.parse_stm_line(line)
    assert t_gen.parse_stm_line(";; comment") is None
    assert t_gen.parse_stm_line(
        "T 1 s 0 1 <o> ignore_time_segment_in_scoring") is None
    src, dst = str(tmp_path / "a" / "in.wav"), str(tmp_path / "b" / "out.wav")
    _wav(src, 0.5, sr=8000)
    t_gen.convert_audio(src, dst)
    samples, sr = audio_mod.read_wav(dst)
    assert sr == 16000 and abs(len(samples) - 8000) <= 1
    (tmp_path / "x.mp3").write_bytes(b"not audio")
    if t_gen._converter() is None:
        with pytest.raises(RuntimeError, match="cannot convert"):
            t_gen.convert_audio(str(tmp_path / "x.mp3"), dst)


def test_merge_manifests_and_cli_prepare_commands(tmp_path, capsys):
    ls, tm = tmp_path / "LibriSpeech", tmp_path / "TIMIT"
    _librispeech(ls)
    _timit(tm)
    assert cli.main(["prepare-librispeech", "--root", str(ls), "--out",
                     str(tmp_path / "ls_out")]) == 0
    ls_csv = capsys.readouterr().out.strip()
    assert ls_csv.endswith("dev-mini.csv") and len(_rows(ls_csv)) == 2
    assert cli.main(["prepare-corpus", "timit", "--root", str(tm), "--out",
                     str(tmp_path / "tm_out"), "--split", "TRAIN"]) == 0
    tm_csv = capsys.readouterr().out.strip()
    assert tm_csv.endswith("timit_train.csv")
    merged = str(tmp_path / "merged.csv")
    assert cli.main(["prepare-corpus", "merge", "--out", merged,
                     "--manifests", ls_csv, tm_csv]) == 0
    assert capsys.readouterr().out.strip() == merged
    want = j_gen.merge_manifests([ls_csv, tm_csv],
                                 str(tmp_path / "merged_ref.csv"))
    assert _rows(merged) == _rows(want) and len(_rows(merged)) == 3
    durs = [r[1] for r in _rows(merged)]
    assert durs == sorted(durs)
    with pytest.raises(SystemExit):                  # merge needs inputs
        cli.main(["prepare-corpus", "merge", "--out", merged])
    with pytest.raises(SystemExit):                  # a corpus needs a root
        cli.main(["prepare-corpus", "timit", "--out", merged])
    capsys.readouterr()


def test_cli_prepare_synth_hard_matches_reference(tmp_path, capsys):
    from ctc_asr_tpu import cli as j_cli
    args = ["--n-train", "6", "--n-dev", "2", "--n-test", "3", "--seed", "4",
            "--vocab-size", "32"]
    assert cli.main(["prepare-synth-hard", "--out", str(tmp_path / "t"),
                     *args]) == 0
    got = dict(ln.split("\t") for ln in
               capsys.readouterr().out.strip().splitlines())
    assert j_cli.main(["prepare-synth-hard", "--out", str(tmp_path / "j"),
                       *args]) == 0
    want = dict(ln.split("\t") for ln in
                capsys.readouterr().out.strip().splitlines())
    assert sorted(got) == sorted(want) == ["dev", "test", "train"]
    for k in got:
        assert _rows(got[k]) == _rows(want[k]) and _rows(got[k])
    a = read_manifest(got["train"])[0].path
    b = read_manifest(want["train"])[0].path
    np.testing.assert_array_equal(audio_mod.read_wav(a)[0],
                                  audio_mod.read_wav(b)[0])


def test_cli_offers_the_reference_commands():
    from ctc_asr_tpu import cli as j_cli
    assert list(cli.COMMANDS) == list(j_cli.COMMANDS)
    assert len(cli.COMMANDS) == 11
