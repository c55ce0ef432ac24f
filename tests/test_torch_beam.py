"""The port's prefix beam search (plain PyTorch path, CPU) against the
JAX reference ``ctc_asr_tpu/ops/beam.py`` and the dict-based oracle, on
the same seeded numpy logits: acoustic, char-LM fusion at orders 2-4
with weights and word bonus, N-best, ragged and zero lengths, the long
decode buffer and its clamp, peaked posteriors, exact score ties.

Tolerances: ids and lengths are identical; scores agree within 1e-4
(f32 log-sum-exps taken in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from beam_select_cases import SELECT_CASES, select_case
from ctc_asr_tpu.ops import beam as j_beam
from ctc_asr_tpu.ops import lm as j_lm
from ctc_asr_tpu.ops.greedy import greedy_decode as j_greedy
from ctc_asr_tpu_torch.config import Config, DataConfig, DecodeConfig
from ctc_asr_tpu_torch.ops import beam as t_beam
from ctc_asr_tpu_torch.ops import beam_cuda
from torch_threads import one_thread  # noqa: F401  (autouse)

SCORE_TOL = 1e-4
LIVE = -1e29


def oracle_prefix_beam(log_probs, K, blank):
    """Textbook dict-based prefix beam search. log_probs [T, C] numpy."""
    T, C = log_probs.shape
    NEG = -1e30
    beams = {(): (0.0, NEG)}  # prefix -> (p_b, p_nb)
    for t in range(T):
        lp = log_probs[t]
        new = {}

        def upd(prefix, pb=None, pnb=None):
            cpb, cpnb = new.get(prefix, (NEG, NEG))
            if pb is not None:
                cpb = np.logaddexp(cpb, pb)
            if pnb is not None:
                cpnb = np.logaddexp(cpnb, pnb)
            new[prefix] = (cpb, cpnb)

        for prefix, (pb, pnb) in beams.items():
            total = np.logaddexp(pb, pnb)
            upd(prefix, pb=total + lp[blank])
            if prefix:
                upd(prefix, pnb=pnb + lp[prefix[-1]])
            for c in range(C - 1):
                p = (pb + lp[c]) if (prefix and c == prefix[-1]) \
                    else (total + lp[c])
                upd(prefix + (c,), pnb=p)
        beams = dict(sorted(new.items(),
                            key=lambda kv: -np.logaddexp(*kv[1]))[:K])
    best = max(beams.items(), key=lambda kv: np.logaddexp(*kv[1]))
    return list(best[0]), float(np.logaddexp(*best[1]))


def _logits(seed, B, T, C, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32) * scale
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    return logits, lens


def _lists(ids, lens):
    ids, lens = np.asarray(ids), np.asarray(lens)
    return [list(map(int, ids[b, :int(lens[b])]))
            for b in range(ids.shape[0])]


def _both(logits, lens, K, C, **kw):
    """(reference, port) outputs of the same call on the same inputs."""
    jkw = dict(kw)
    if jkw.get("lm_table") is not None:
        jkw["lm_table"] = jnp.asarray(jkw["lm_table"])
    want = j_beam.beam_search_decode(
        jnp.asarray(logits), jnp.asarray(lens), beam_width=K,
        blank_id=C - 1, **jkw)
    got = t_beam.beam_search_decode(
        torch.from_numpy(logits), torch.from_numpy(lens), beam_width=K,
        blank_id=C - 1, **kw)
    return ([np.asarray(x) for x in want], [x.numpy() for x in got])


def _assert_nbest_equal(want, got):
    """Live entries: same prefixes in the same order, scores within
    SCORE_TOL; the rest of both lists is dead."""
    (xi, xl, xs), (pi, pl, ps) = want, got
    assert pi.shape == xi.shape and pi.dtype == np.int32
    B, K = xs.shape
    for b in range(B):
        for k in range(K):
            if xs[b, k] < LIVE:
                assert ps[b, k] < LIVE, (b, k)
                continue
            assert list(pi[b, k, :pl[b, k]]) == list(xi[b, k, :xl[b, k]]), \
                (b, k)
            assert abs(float(ps[b, k]) - float(xs[b, k])) <= SCORE_TOL


@pytest.mark.parametrize("seed,T,C,K", [(0, 8, 5, 4), (1, 12, 6, 8),
                                        (2, 15, 4, 16), (3, 10, 8, 8)])
def test_matches_reference_and_oracle(seed, T, C, K):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((1, T, C)).astype(np.float32) * 2.0
    lens = np.array([T], np.int32)
    want, got = _both(logits, lens, K, C, space_id=0)
    assert _lists(*got) == _lists(*want)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[0]), -1))
    o_ids, o_score = oracle_prefix_beam(lp, K, blank=C - 1)
    assert _lists(*got)[0] == o_ids
    # the best score is the oracle's. (At C=4, K=16 fewer than K live
    # candidates exist in the first steps; the reference then picks
    # merged-away duplicates and counts their mass twice, so its N-best
    # scores are not compared there.)
    _, _, scores = t_beam.beam_search_decode(
        torch.from_numpy(logits), torch.from_numpy(lens), beam_width=K,
        blank_id=C - 1, return_nbest=True)
    assert abs(float(scores[0, 0]) - o_score) <= SCORE_TOL


@pytest.mark.parametrize("seed,B,T,C,K", [(0, 2, 8, 6, 8), (1, 1, 12, 6, 8),
                                          (2, 3, 10, 5, 16),
                                          (5, 2, 14, 29, 8)])
def test_nbest_matches_reference(seed, B, T, C, K):
    logits, lens = _logits(seed, B, T, C)
    want, got = _both(logits, lens, K, C, return_nbest=True)
    _assert_nbest_equal(want, got)
    best = t_beam.beam_search_decode(
        torch.from_numpy(logits), torch.from_numpy(lens), beam_width=K,
        blank_id=C - 1)
    np.testing.assert_array_equal(best[0].numpy(), got[0][:, 0])
    np.testing.assert_array_equal(best[1].numpy(), got[1][:, 0])


_TEXTS = ["the cat sat on the mat", "a quick brown fox",
          "hello world how are you",
          "this is a test of the language model fusion path"]


@pytest.mark.parametrize("seed,B,T,K,order,w,bonus", [
    (0, 2, 16, 8, 2, 0.5, 0.0),
    (1, 3, 24, 8, 3, 0.6, 0.5),
    (2, 1, 30, 16, 3, 1.2, 1.0),
    (4, 2, 20, 8, 4, 0.8, 1.0),
])
def test_lm_fusion_matches_reference(seed, B, T, K, order, w, bonus):
    lm = j_lm.train_char_lm(_TEXTS * 3, order=order)
    logits, lens = _logits(seed, B, T, 29)
    want, got = _both(logits, lens, K, 29, lm_table=lm["table"], lm_weight=w,
                      word_bonus=bonus,
                      init_ctx=j_lm.initial_context(order), return_nbest=True)
    _assert_nbest_equal(want, got)


def test_small_vocab_order5_context_arithmetic():
    """Four context digits (an order-5 LM) over a 5-symbol vocabulary:
    625 contexts, so ``(ctx * V + c) % n_ctx`` wraps as at full size."""
    V, C, order = 5, 6, 5
    rng = np.random.default_rng(8)
    table = np.log(rng.dirichlet(np.ones(V), size=V ** (order - 1))
                   ).astype(np.float32)
    logits, lens = _logits(8, 2, 18, C)
    want, got = _both(logits, lens, 8, C, lm_table=table, lm_weight=0.7,
                      word_bonus=0.3, init_ctx=0, lm_vocab=V,
                      return_nbest=True)
    _assert_nbest_equal(want, got)


def test_respects_logit_lengths_and_empty_rows():
    rng = np.random.default_rng(5)
    C, T, K = 5, 10, 6
    logits = rng.standard_normal((3, T, C)).astype(np.float32) * 2.0
    lens = np.array([T, 4, 0], np.int32)
    want, got = _both(logits, lens, K, C)
    assert _lists(*got) == _lists(*want)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[1, :4]), -1))
    assert _lists(*got)[1] == oracle_prefix_beam(lp, K, blank=C - 1)[0]
    assert _lists(*got)[2] == [] and int(got[1][2]) == 0
    # batched == one by one
    for b in range(3):
        one = t_beam.beam_search_decode(
            torch.from_numpy(logits[b:b + 1]), torch.from_numpy(lens[b:b + 1]),
            beam_width=K, blank_id=C - 1)
        assert _lists(*one)[0] == _lists(*got)[b]


def test_peaked_logits_match_greedy():
    rng = np.random.default_rng(7)
    B, T, C = 3, 20, 29
    path = rng.integers(0, C, (B, T))
    logits = np.full((B, T, C), -8.0, np.float32)
    for b in range(B):
        logits[b, np.arange(T), path[b]] = 8.0
    lens = np.full(B, T, np.int32)
    g_ids, g_lens = j_greedy(jnp.asarray(logits), jnp.asarray(lens))
    ids, dlens = t_beam.beam_search_decode(
        torch.from_numpy(logits), torch.from_numpy(lens), beam_width=8)
    assert _lists(ids, dlens) == _lists(g_ids, g_lens)


def test_long_decode_buffer_and_clamp():
    cfg = Config(data=DataConfig(max_audio_seconds=30.0),
                 decode=DecodeConfig(method="beam"))
    derived = t_beam.derive_max_decode_len(cfg.decode, cfg.data)
    assert derived == j_beam.derive_max_decode_len(cfg.decode, cfg.data) == 480
    assert t_beam.derive_max_decode_len(DecodeConfig(max_decode_len=123),
                                        cfg.data) == 123
    # a 300-char transcript decodes fully through the derived buffer
    n_chars = 300
    T, C = 2 * n_chars, 29
    logits = np.full((1, T, C), -10.0, np.float32)
    text = [(i % 27) + 1 for i in range(n_chars)]
    logits[0, 2 * np.arange(n_chars), text] = 10.0
    logits[0, 2 * np.arange(n_chars) + 1, C - 1] = 10.0
    ids, lens = t_beam.beam_search_decode(
        torch.from_numpy(logits), torch.tensor([T], dtype=torch.int32),
        beam_width=2, max_decode_len=derived)
    assert ids.shape == (1, 480) and _lists(ids, lens)[0] == text
    # without it the buffer is min(T, 256): the length clamps at U and
    # later characters are dropped, as in the reference
    want, got = _both(logits, np.array([T], np.int32), 2, C)
    assert got[0].shape == (1, 256) and int(got[1][0]) == 256
    assert _lists(*got) == _lists(*want) == [text[:256]]
    # a clamp in the middle of a soft decode
    logits, lens = _logits(7, 2, 40, 29)
    want, got = _both(logits, lens, 8, 29, max_decode_len=12)
    assert got[0].shape == (2, 12)
    assert _lists(*got) == _lists(*want)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_tied_scores_same_beam_set(seed):
    """Quantized logits make many candidates tie exactly, and a word
    bonus of 3 per space over a flat LM table drives the fused scores
    positive. Ties may permute beam rows between the two decoders, but
    the selected set has the same sorted live-score multiset."""
    B, T, C, K = 2, 10, 6, 8
    rng = np.random.default_rng(seed)
    logits = (np.round(rng.standard_normal((B, T, C)) * 2) / 2.0
              ).astype(np.float32)
    lens = np.full(B, T, np.int32)
    table = np.zeros((C - 1, C - 1), np.float32)
    for kw in ({}, dict(lm_table=table, lm_weight=1.0, word_bonus=3.0,
                        lm_vocab=C - 1)):
        (_, _, xs), (_, _, ps) = _both(logits, lens, K, C, return_nbest=True,
                                       **kw)
        for b in range(B):
            xlive = np.sort(xs[b][xs[b] > LIVE])
            plive = np.sort(ps[b][ps[b] > LIVE])
            assert xlive.shape == plive.shape, (seed, b)
            np.testing.assert_allclose(plive, xlive, rtol=0, atol=SCORE_TOL)
            assert abs(float(xs[b, 0]) - float(ps[b, 0])) <= SCORE_TOL
        if kw:
            assert ps.max() > 0


@pytest.mark.parametrize("seed", [106, 1, 9])
def test_no_duplicate_live_prefixes(seed):
    rng = np.random.default_rng(seed)
    T, K = 16, 8
    logits = rng.standard_normal((1, T, 29)).astype(np.float32) * 2
    ids, lens, scores = t_beam.beam_search_decode(
        torch.from_numpy(logits), torch.tensor([T]), beam_width=K,
        return_nbest=True)
    live = [tuple(ids[0, k, :int(lens[0, k])].tolist())
            for k in range(K) if float(scores[0, k]) > LIVE]
    assert len(live) == K and len(set(live)) == K


def test_bad_input_raises():
    logits = torch.zeros(1, 4, 6)
    lens = torch.tensor([4])
    for fn in (t_beam.beam_search_decode, beam_cuda.beam_search_decode_cuda):
        with pytest.raises(ValueError, match="blank"):
            fn(logits, lens, blank_id=2)
        with pytest.raises(ValueError, match="LM vocab"):
            fn(logits, lens, blank_id=5, lm_table=np.zeros((7, 7), np.float32),
               lm_weight=0.5, lm_vocab=7)


def test_wrapper_on_cpu_is_the_plain_version():
    logits, lens = _logits(3, 2, 12, 29)
    lm = j_lm.train_char_lm(_TEXTS, order=2)
    kw = dict(beam_width=8, lm_table=lm["table"], lm_weight=0.5,
              word_bonus=0.5, init_ctx=j_lm.initial_context(2),
              return_nbest=True)
    n0 = beam_cuda.beam_search_decode_cuda.launches
    got = beam_cuda.beam_search_decode_cuda(
        torch.from_numpy(logits), torch.from_numpy(lens), **kw)
    want = t_beam.beam_search_decode(
        torch.from_numpy(logits), torch.from_numpy(lens), **kw)
    assert beam_cuda.beam_search_decode_cuda.launches == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_make_beam_decoder_matches_reference(use_kernel):
    """An LM that has only seen 'b' flips an acoustic near-tie; without
    an LM the weights are forced to 0. Same decodes as the reference's
    factory."""
    lm = j_lm.train_char_lm(["bbbbbb bbbb", "bbb bbbbb"], order=2)
    C, T = 29, 6
    logits = np.full((1, T, C), -5.0, np.float32)
    logits[0, :, 1] = 2.0
    logits[0, :, 2] = 1.9
    lens = np.array([T], np.int32)
    for kw in (dict(), dict(lm=lm, lm_weight=3.0), dict(word_bonus=5.0)):
        want = j_beam.make_beam_decoder(beam_width=8, **kw)(
            jnp.asarray(logits), jnp.asarray(lens))
        dec = t_beam.make_beam_decoder(beam_width=8, use_kernel=use_kernel,
                                       **kw)
        got = dec(torch.from_numpy(logits), torch.from_numpy(lens))
        assert _lists(*got) == _lists(*want)
    ids, dlens, scores = t_beam.make_beam_decoder(
        beam_width=8, lm=lm, lm_weight=3.0, use_kernel=use_kernel,
        return_nbest=True)(torch.from_numpy(logits), torch.from_numpy(lens))
    assert ids.shape == (1, 8, T) and scores.shape == (1, 8)
    assert _lists(ids[:, 0], dlens[:, 0])[0].count(2) > 0


@pytest.mark.parametrize("name,N,K", SELECT_CASES)
def test_selection_probe_on_cpu_is_the_reference_order(name, N, K):
    """The order K8's selection is held to (``select_top_k_probe`` on a
    CPU tensor: a stable sort of ``_sort_key``) on the crafted cases of
    its card test, against numpy's lexsort of (score descending, -0 equal
    to +0; first hash ascending; index ascending)."""
    scores, h1 = select_case(name, N, K)
    keys, idx = beam_cuda.select_top_k_probe(
        torch.from_numpy(scores), torch.from_numpy(h1), K)
    hu = h1.view(np.uint32).astype(np.int64)
    want = np.lexsort((np.arange(N), hu, -(scores.astype(np.float64) + 0.0)))
    assert idx.tolist() == want[:K].tolist()
    assert (keys[:-1] >= keys[1:]).all()
    assert keys.tolist() == t_beam._sort_key(
        torch.from_numpy(scores[want[:K]]), torch.from_numpy(hu[want[:K]])
    ).tolist()


def test_selection_shapes_for_every_accepted_beam():
    """Every (K, C) the kernel takes, with the chunk length of
    ``select_chunk`` in ``csrc/beam.cu`` (K rounded up to a power of two,
    at least 64): the chunk a warp sorts holds the K best (L >= K), whole
    chunks tile the sort width in a power-of-two count (the merge tree
    pairs them level by level), and the block has a thread for each
    beam."""
    for K in range(1, beam_cuda.MAX_BEAM + 1):
        L = 1 << (max(64, K) - 1).bit_length()
        assert L >= max(K, 64) and L < 2 * max(K, 64)
        for C in range(2, beam_cuda.MAX_CLASSES + 1):
            NP = beam_cuda.sort_width(K, C)
            if NP > beam_cuda.MAX_SORT_KEYS:
                break
            chunks = NP // L
            assert chunks * L == NP and chunks & (chunks - 1) == 0
            assert min(NP // 2, 1024) >= K


def test_selection_probe_rejects_bad_input():
    s, h = torch.zeros(100), torch.zeros(100, dtype=torch.int32)
    for k in (0, 101):
        with pytest.raises(ValueError, match="selection"):
            beam_cuda.select_top_k_probe(s, h, k)
    with pytest.raises(ValueError, match="selection"):
        beam_cuda.select_top_k_probe(torch.zeros(20000), h, 8)
