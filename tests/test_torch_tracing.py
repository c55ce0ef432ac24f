"""The port's tracing on the CPU, on the plain paths: ``utils.profiling``'s
spans enter no profiler range while nothing traces and leave the step's
numbers as they were; under ``torch.profiler`` each layer's span is
recorded where its work happens, nested in its caller's on one thread;
the word-LM rescoring counts its lookups and cache misses."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ctc_asr_tpu_torch import evaluate as t_eval
from ctc_asr_tpu_torch import train as t_train
from ctc_asr_tpu_torch.config import (Config, DataConfig, DecodeConfig,
                                      FeatureConfig, ModelConfig, TrainConfig)
from ctc_asr_tpu_torch.features import FEATURES_RANGE
from ctc_asr_tpu_torch.models.encoder import FRONTEND_RANGE, RNN_RANGE
from ctc_asr_tpu_torch.models.rnn import RECURRENCE_RANGE
from ctc_asr_tpu_torch.ops import lm as t_lm
from ctc_asr_tpu_torch.ops.ctc_cuda import CTC_RANGE
from ctc_asr_tpu_torch.optim import ADAM_RANGE
from ctc_asr_tpu_torch.utils import profiling

LAYERS = 2
B, S, U = 2, 8000, 3          # 0.5 s rows: 48 frames, 24 after the convs
CORPUS = ["the cat sat", "a dog ran", "the dog sat on a mat", "cat and dog"]

# each span's parent on the same thread, inside one train step
PARENT = {FEATURES_RANGE: t_train.STEP_RANGE,
          FRONTEND_RANGE: t_train.STEP_RANGE,
          RNN_RANGE: t_train.STEP_RANGE,
          RECURRENCE_RANGE: RNN_RANGE,
          CTC_RANGE: t_train.STEP_RANGE,
          ADAM_RANGE: t_train.STEP_RANGE}


def _cfg(rnn_type="lstm", remat=False, decode=None) -> Config:
    return Config(
        features=FeatureConfig(n_mels=40, use_pallas=False),
        model=ModelConfig(frontend="conv", conv_channels=(4, 4),
                          conv_kernels=((5, 11), (3, 5)),
                          rnn_layers=LAYERS, rnn_units=16,
                          bidirectional=True, rnn_type=rnn_type,
                          dropout=0.1, compute_dtype="float32",
                          use_pallas_rnn=False, remat=remat),
        data=DataConfig(batch_size=B, num_buckets=1),
        train=TrainConfig(use_pallas_ctc=False, learning_rate=1e-3),
        decode=decode or DecodeConfig())


def _batch(seed: int):
    g = np.random.default_rng(seed)
    samples = torch.from_numpy(
        g.integers(-3000, 3000, (B, S)).astype(np.int16))
    slens = torch.tensor([S, S - 1600], dtype=torch.int32)
    labels = torch.from_numpy(g.integers(0, 27, (B, U)).astype(np.int32))
    return samples, slens, labels, torch.tensor([U, U - 1], dtype=torch.int32)


def _train(cfg, traced: bool, steps: int = 2):
    """Two train steps from the same state; the losses, the parameters
    and, when traced, the profiler's host events."""
    state = t_train.init_train_state(cfg, "cpu")
    step_fn = t_train.make_step_fn(cfg)
    losses, events = [], None

    def run():
        for i in range(steps):
            losses.append(step_fn(state, *_batch(i))["loss"])
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        events = prof.events()
    else:
        run()
    return losses, {k: v.detach() for k, v in state["params"].items()}, \
        events


def _spans(events, names) -> dict:
    """name -> [(start, end, thread)] of the host events so named."""
    out = {n: [] for n in names}
    for e in events:
        if e.name in out:
            out[e.name].append((e.time_range.start, e.time_range.end,
                                e.thread))
    return out


def _inside(child, parents) -> bool:
    s, e, th = child
    return any(ps <= s and e <= pe and pt == th for ps, pe, pt in parents)


@pytest.mark.parametrize("remat", [False, True])
def test_untraced_span_enters_no_range(monkeypatch, remat):
    """With no profiler running, a train step opens no ``record_function``
    (each span is one flag check); traced, it opens them, and the losses
    and the updated parameters are the untraced run's, bit for bit."""
    calls = []
    real = profiling.record_function

    def counting(name):
        calls.append(name)
        return real(name)
    monkeypatch.setattr(profiling, "record_function", counting)
    cfg = _cfg(remat=remat)
    loss0, params0, _ = _train(cfg, traced=False)
    assert calls == []
    loss1, params1, _ = _train(cfg, traced=True)
    assert t_train.STEP_RANGE in calls and RECURRENCE_RANGE in calls
    assert [float(v) for v in loss0] == [float(v) for v in loss1]
    for k in params0:
        assert torch.equal(params0[k], params1[k]), k


@pytest.mark.parametrize("rnn_type,remat", [("lstm", False), ("lstm", True),
                                            ("gru", False)])
def test_train_step_spans_nest(rnn_type, remat):
    """Each layer's span is recorded once a step (each RNN layer's once
    a layer, and once more in the backward's recomputation with
    ``remat``), each inside its parent on the same thread."""
    steps = 2
    _, _, events = _train(_cfg(rnn_type, remat), traced=True, steps=steps)
    spans = _spans(events, set(PARENT) | {t_train.STEP_RANGE})
    per_layer = LAYERS * (2 if remat else 1)
    want = {t_train.STEP_RANGE: 1, FEATURES_RANGE: 1, FRONTEND_RANGE: 1,
            CTC_RANGE: 1, ADAM_RANGE: 1, RNN_RANGE: per_layer,
            RECURRENCE_RANGE: per_layer}
    assert {n: len(v) for n, v in spans.items()} == \
        {n: steps * k for n, k in want.items()}
    for name, parent in PARENT.items():
        for child in spans[name]:
            assert _inside(child, spans[parent]), (name, parent)


def _decoder_cfg(tmp_path) -> Config:
    char_lm, word_lm = tmp_path / "char.npz", tmp_path / "word.pkl"
    t_lm.save_lm(str(char_lm), t_lm.train_char_lm(CORPUS, order=3))
    t_lm.save_word_lm(str(word_lm), t_lm.train_word_lm(CORPUS, order=2))
    return _cfg(decode=DecodeConfig(
        method="beam", beam_width=4, nbest=4, use_pallas=False,
        lm_path=str(char_lm), word_lm_path=str(word_lm)))


class _HostBatch:
    def __init__(self, seed):
        samples, slens, _, _ = _batch(seed)
        self.samples, self.sample_lengths = samples.numpy(), slens.numpy()


@pytest.mark.parametrize("batches", [1, 3])
def test_fusion_decode_spans(tmp_path, batches):
    """A fusion decode fed by ``train.device_batches`` records one upload
    and one ``pick_best`` a batch, the texts and the rescoring inside
    ``pick_best``, the features inside nothing of the decoder's."""
    cfg = _decoder_cfg(tmp_path)
    params = {k: v.detach() for k, v in
              t_train.init_train_state(cfg, "cpu")["params"].items()}
    eval_step = t_eval.make_eval_step(cfg, "cpu")
    decode, pick_best = t_eval.make_nbest_decoder(cfg)
    feed = t_train.device_batches((_HostBatch(i) for i in range(batches)),
                                  None, torch.device("cpu"),
                                  with_labels=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _, (d_s, d_l) in feed:
            ids, lens = pick_best(*decode(*eval_step(params, d_s, d_l)))
            assert ids.shape[0] == B and lens.shape == (B,)
    names = (t_train.UPLOAD_RANGE, t_eval.PICK_BEST_RANGE,
             t_eval.NBEST_TEXTS_RANGE, t_lm.RESCORE_RANGE, FEATURES_RANGE)
    spans = _spans(prof.events(), names)
    assert {n: len(v) for n, v in spans.items()} == dict.fromkeys(
        names, batches)
    for child in (t_eval.NBEST_TEXTS_RANGE, t_lm.RESCORE_RANGE):
        for s in spans[child]:
            assert _inside(s, spans[t_eval.PICK_BEST_RANGE]), child
    for s in spans[FEATURES_RANGE]:
        assert not _inside(s, spans[t_eval.PICK_BEST_RANGE])


@pytest.mark.parametrize("shared_cache", [True, False])
def test_rescore_counts_lookups_and_misses(shared_cache):
    """A [2][4] N-best with repeats: 8 lookups, as many scored as there
    are distinct texts; a second call scores none when it shares the
    first call's cache, all of them again when it has none."""
    texts = [["the cat", "the cat", "a dog", ""],
             ["a dog", "the mat", "the cat", "the mat"]]
    am = np.zeros((2, 4))
    wlm = t_lm.train_word_lm(CORPUS, order=2)
    cache = {} if shared_cache else None
    distinct = len({t for row in texts for t in row})

    def delta(call):
        before = profiling.counters()
        call()
        after = profiling.counters()
        return tuple(after.get(k, 0) - before.get(k, 0)
                     for k in (t_lm.LOOKUPS_COUNTER, t_lm.SCORED_COUNTER))

    def call():
        t_lm.rescore_nbest_batch(texts, am, wlm, cache=cache)
    assert delta(call) == (8, distinct)
    assert delta(call) == (8, 0 if shared_cache else distinct)


def test_counters_are_a_copy():
    profiling.count("test.counter", 3)
    got = profiling.counters()
    got["test.counter"] = 0
    assert profiling.counters()["test.counter"] >= 3
