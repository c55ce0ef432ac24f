"""The benchmark's n-gram LMs, made from the mix's seeded text and written
in the files the port reads (``decode.lm_path``: an ``.npz`` with
``table`` and ``order``; ``decode.word_lm_path``: a pickle with
``order``, ``vocab`` and ``counts``). The reference reads the same files.

A frozen copy of the counting in ``ctc_asr_tpu_torch/ops/lm.py``
(``train_char_lm``, ``train_word_lm``): Witten-Bell interpolation down
to an add-one unigram, the char LM materialized as a dense
[V^(N-1), V] table of log-probabilities over the 28 label symbols, the
utterance start padded with the space symbol. The char counts are taken
with ``np.bincount`` over base-V context ids instead of per-context
dicts; the table is the same.
"""

from __future__ import annotations

import pickle

import numpy as np

from .traffic import ALPHABET

V = len(ALPHABET)
BOS = 0


def _encode(text: str) -> np.ndarray:
    table = {c: i for i, c in enumerate(ALPHABET)}
    return np.asarray([table[c] for c in text if c in table], np.int64)


def char_lm_table(texts, order: int) -> np.ndarray:
    """[V^(order-1), V] float32 log P(c | context)."""
    ids = [np.concatenate([np.full(order - 1, BOS, np.int64), _encode(t)])
           for t in texts]
    counts = []
    for k in range(order):
        keys = []
        for seq in ids:
            n = len(seq) - (order - 1)
            ctx = np.zeros(n, np.int64)
            for j in range(k):      # context digits, oldest first
                ctx = ctx * V + seq[order - 1 - k + j:order - 1 - k + j + n]
            keys.append(ctx * V + seq[order - 1:])
        counts.append(np.bincount(np.concatenate(keys),
                                  minlength=V ** (k + 1)
                                  ).reshape(V ** k, V).astype(np.float64))
    uni = counts[0][0]
    p = np.broadcast_to((uni + 1.0) / (uni.sum() + V),
                        (V ** (order - 1), V)).copy()
    full = np.arange(V ** (order - 1))
    for k in range(1, order):
        rows = counts[k][full % V ** k]
        n = rows.sum(1, keepdims=True)
        types = np.maximum((rows > 0).sum(1, keepdims=True), 1.0)
        lam = n / np.maximum(n + types, 1e-300)
        seen = n > 0
        p = np.where(seen, lam * rows / np.maximum(n, 1e-300)
                     + (1.0 - lam) * p, p)
    return np.log(np.maximum(p, 1e-12)).astype(np.float32)


def word_lm(texts, order: int) -> dict:
    """Witten-Bell word n-gram counts: {"order", "vocab", "counts"}."""
    counts = [dict() for _ in range(order)]
    vocab = set()
    bos = ("<s>",) * (order - 1)
    for text in texts:
        words = tuple(text.split())
        vocab.update(words)
        seq = bos + words + ("</s>",)
        for i in range(order - 1, len(seq)):
            w = seq[i]
            for k in range(order):
                d = counts[k].setdefault(seq[i - k:i], {})
                d[w] = d.get(w, 0) + 1
    return {"order": order, "vocab": vocab, "counts": counts}


def write_lms(texts, char_order: int, word_order: int, char_path: str,
              word_path: str) -> None:
    np.savez_compressed(char_path, table=char_lm_table(texts, char_order),
                        order=np.int32(char_order))
    lm = word_lm(texts, word_order)
    with open(word_path, "wb") as f:
        pickle.dump({"order": lm["order"], "vocab": sorted(lm["vocab"]),
                     "counts": lm["counts"]}, f)
