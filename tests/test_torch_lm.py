"""The port's ``ops/lm.py`` (numpy) against ``ctc_asr_tpu/ops/lm.py``:
char-LM tables equal exactly, scores to 1e-6, the word LM's scores and
N-best picks equal, and files written by one package load in the other.
"""

import numpy as np
import pytest

from ctc_asr_tpu.ops import lm as j_lm
from ctc_asr_tpu_torch.ops import lm as t_lm

CORPUS = ["the cat sat on the mat", "the dog sat on the rug",
          "a cat and a dog", "the cat ran", "it's a dog's life",
          "hello world how are you"] * 3
PROBES = ["the cat sat", "mat the a", "zebra crossing", "", "it's"]


@pytest.mark.parametrize("order", [2, 3, 4])
def test_char_lm_table_and_scores_equal(order):
    want = j_lm.train_char_lm(CORPUS, order=order)
    got = t_lm.train_char_lm(CORPUS, order=order)
    assert got["table"].dtype == np.float32
    assert got["table"].shape == (28 ** (order - 1), 28)
    np.testing.assert_array_equal(got["table"], want["table"])
    assert int(got["order"]) == int(want["order"]) == order
    assert t_lm.initial_context(order) == j_lm.initial_context(order)
    assert (t_lm.V, t_lm.BOS) == (j_lm.V, j_lm.BOS)
    for text in PROBES:
        assert abs(t_lm.score_text(got, text)
                   - j_lm.score_text(want, text)) <= 1e-6
    ctx = t_lm.initial_context(order)
    for c in (3, 0, 27, 5):
        assert t_lm.next_context(ctx, c, order) == \
            j_lm.next_context(ctx, c, order)
        ctx = t_lm.next_context(ctx, c, order)
    with pytest.raises(ValueError):
        t_lm.train_char_lm(CORPUS, order=1)


@pytest.mark.parametrize("writer,reader", [(j_lm, t_lm), (t_lm, j_lm)])
def test_char_lm_files_cross_load(tmp_path, writer, reader):
    lm = writer.train_char_lm(CORPUS, order=3)
    path = str(tmp_path / "lm.npz")
    writer.save_lm(path, lm)
    back = reader.load_lm(path)
    np.testing.assert_array_equal(back["table"], lm["table"])
    assert back["order"] == 3
    assert abs(reader.score_text(back, "the cat")
               - writer.score_text(lm, "the cat")) <= 1e-6


@pytest.mark.parametrize("order", [1, 2, 3])
def test_word_lm_scores_equal(order):
    want = j_lm.train_word_lm(CORPUS, order=order)
    got = t_lm.train_word_lm(CORPUS, order=order)
    assert got["vocab"] == want["vocab"] and got["counts"] == want["counts"]
    for text in PROBES:
        assert abs(t_lm.score_words(got, text)
                   - j_lm.score_words(want, text)) <= 1e-6
    assert abs(t_lm.word_logprob(got, ("the",), "cat")
               - j_lm.word_logprob(want, ("the",), "cat")) <= 1e-6
    assert np.isfinite(t_lm.word_logprob(got, ("the",), "zebra"))
    with pytest.raises(ValueError):
        t_lm.train_word_lm(CORPUS, order=0)


@pytest.mark.parametrize("writer,reader", [(j_lm, t_lm), (t_lm, j_lm)])
def test_word_lm_files_cross_load(tmp_path, writer, reader):
    wlm = writer.train_word_lm(CORPUS, order=2)
    path = str(tmp_path / "wlm.pkl")
    writer.save_word_lm(path, wlm)
    back = reader.load_word_lm(path)
    for text in PROBES:
        assert abs(reader.score_words(back, text)
                   - writer.score_words(wlm, text)) <= 1e-9


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.0, 0.0), (0.7, 0.5)])
def test_rescoring_picks_equal(alpha, beta):
    rng = np.random.default_rng(3)
    words = sorted({w for s in CORPUS for w in s.split()}) + ["sab", "tha"]
    texts = [[" ".join(rng.choice(words, rng.integers(1, 6)))
              for _ in range(8)] for _ in range(6)]
    texts[0][:3] = ["the cat sat", "the cat sab", "tha cat sat"]
    texts[1][2] = texts[1][0]                      # a duplicate hypothesis
    am = (rng.standard_normal((6, 8)) * 0.3 - 10).astype(np.float32)
    jw, tw = (m.train_word_lm(CORPUS, order=2) for m in (j_lm, t_lm))
    want = j_lm.rescore_nbest_batch(texts, am, jw, alpha=alpha, beta=beta)
    cache = {}
    got = t_lm.rescore_nbest_batch(texts, am, tw, alpha=alpha, beta=beta,
                                   cache=cache)
    np.testing.assert_array_equal(got, want)
    assert cache and set(cache) <= {t for row in texts for t in row}
    for b in range(6):
        assert t_lm.rescore_nbest(texts[b], am[b], tw, alpha=alpha,
                                  beta=beta) == int(want[b])
    if alpha == 1.0:
        assert got[0] == 0 or am[0, 0] < am[0, 1] - 5
