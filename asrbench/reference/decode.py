"""The decode side of the reference: how good an answer is, under the
reference's own log-posteriors and the benchmark's LMs.

- Greedy: the best path's score ``sum_t max_c log p(c | t)`` against
  the best alignment of the answer (a Viterbi pass over its
  blank-interleaved labels). The gap is 0 exactly when the answer is the
  best path's collapse.
- Beam with fusion and rescoring: the answer's score ``log P_ctc(y) +
  lm_weight * log P_char(y) + word_bonus * spaces(y) + rescore_alpha *
  log P_word(y) + rescore_beta * words(y)`` (log P_ctc exact, over all
  alignments) against the score of the reference's own answer: its beam
  search (``reference.beam``, a frozen copy of the port's plain version)
  over its own posteriors, N-best rescored with the word LM.

Nothing here imports the port; the LMs are the benchmark's files.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.nn.functional as F

from . import beam as beam_ref

NEG = -1.0e30
ALPHABET = " abcdefghijklmnopqrstuvwxyz'"
V = len(ALPHABET)


def ids_text(ids) -> str:
    return "".join(ALPHABET[int(i)] for i in ids if 0 <= int(i) < V)


def text_ids(text: str) -> list[int]:
    return [ALPHABET.index(c) for c in text]


# ---------------------------------------------------------------------------
# LMs (the files the benchmark wrote)
# ---------------------------------------------------------------------------

def load_char_lm(path: str) -> dict:
    with np.load(path) as z:
        return {"table": z["table"].astype(np.float32),
                "order": int(z["order"])}


def load_word_lm(path: str) -> dict:
    with open(path, "rb") as f:
        lm = pickle.load(f)
    uni = lm["counts"][0].get((), {})
    lm["uni_total"] = float(sum(uni.values()) or 1)
    lm["nvocab"] = max(len(lm["vocab"]), 1)
    lm["ctx"] = []
    for k in range(1, lm["order"]):
        stats = {}
        for ctx, d in lm["counts"][k].items():
            n = float(sum(d.values()))
            stats[ctx] = (n / (n + len(d)), d, n)
        lm["ctx"].append(stats)
    return lm


def char_lm_score(lm: dict, text: str) -> float:
    """log P(text) under the char LM: the utterance start is the space
    symbol repeated, the context the last order-1 symbols."""
    table, order = lm["table"], lm["order"]
    n_ctx = table.shape[0]
    ctx = 0
    total = 0.0
    for c in text_ids(text):
        total += float(table[ctx, c])
        ctx = (ctx * V + c) % n_ctx
    return total


def word_lm_score(lm: dict, text: str) -> float:
    """log P(words, </s>) under the Witten-Bell word LM (an add-one
    unigram over the vocabulary and one unknown word at the bottom)."""
    order = lm["order"]
    ctx = ("<s>",) * (order - 1)
    uni = lm["counts"][0].get((), {})
    total = 0.0
    for w in text.split() + ["</s>"]:
        p = (uni.get(w, 0) + 1.0) / (lm["uni_total"] + lm["nvocab"] + 1)
        for k in range(1, order):
            sub = tuple(ctx[len(ctx) - k:]) if k <= len(ctx) else None
            entry = lm["ctx"][k - 1].get(sub) if sub is not None else None
            if entry is None:
                continue
            lam, d, n = entry
            p = lam * d.get(w, 0) / n + (1.0 - lam) * p
        total += float(np.log(max(p, 1e-12)))
        ctx = (ctx + (w,))[-(order - 1):] if order > 1 else ()
    return total


# ---------------------------------------------------------------------------
# Scores of answers
# ---------------------------------------------------------------------------

def _padded(answers: list, device) -> tuple[torch.Tensor, torch.Tensor]:
    U = max(1, max(len(a) for a in answers))
    lab = torch.full((len(answers), U), 0, dtype=torch.long)
    for i, a in enumerate(answers):
        lab[i, :len(a)] = torch.as_tensor(a, dtype=torch.long)
    return (lab.to(device),
            torch.as_tensor([len(a) for a in answers], device=device))


@torch.no_grad()
def viterbi_gap(lp: torch.Tensor, lens: torch.Tensor, answers: list
                ) -> np.ndarray:
    """Per row: the best path's log-probability minus that of the
    answer's best alignment (inf where no alignment fits). ``lp`` [B, T,
    C] log-posteriors, blank last; ``answers`` lists of label ids."""
    B, T, C = lp.shape
    blank = C - 1
    lab, ulen = _padded(answers, lp.device)
    S = 2 * lab.shape[1] + 1
    z = torch.full((B, S), blank, dtype=torch.long, device=lp.device)
    z[:, 1::2] = lab
    s_idx = torch.arange(S, device=lp.device)[None, :]
    prev2 = torch.cat([torch.full((B, 2), blank, device=lp.device,
                                  dtype=torch.long), z[:, :-2]], 1)
    skip = (s_idx % 2 == 1) & (z != prev2) & (s_idx >= 2)
    inside = s_idx <= 2 * ulen[:, None]
    lpz = lp.gather(2, z[:, None, :].expand(B, T, S))     # [B, T, S]
    neg = torch.full((B, S), NEG, device=lp.device)
    a = torch.where((s_idx <= 1) & inside, lpz[:, 0], neg)
    for t in range(1, T):
        m = torch.maximum(a, torch.cat([neg[:, :1], a[:, :-1]], 1))
        m = torch.where(skip, torch.maximum(
            m, torch.cat([neg[:, :2], a[:, :-2]], 1)), m)
        nxt = torch.where(inside, m + lpz[:, t], neg)
        a = torch.where((t < lens)[:, None], torch.clamp_min(nxt, NEG), a)
    end = 2 * ulen
    last = a.gather(1, end[:, None])[:, 0]
    before = torch.where(end > 0, a.gather(
        1, torch.clamp_min(end - 1, 0)[:, None])[:, 0],
        torch.full_like(last, NEG))
    best_align = torch.maximum(last, before)
    valid = torch.arange(T, device=lp.device)[None, :] < lens[:, None]
    best_path = (lp.max(-1).values * valid).sum(1)
    gap = (best_path - best_align).double().cpu().numpy()
    gap[best_align.cpu().numpy() <= NEG / 2] = np.inf
    return gap


@torch.no_grad()
def ctc_logp(lp: torch.Tensor, lens: torch.Tensor, answers: list
             ) -> np.ndarray:
    """Per row: log P_ctc(answer | frames), over all alignments."""
    lab, ulen = _padded(answers, lp.device)
    nll = F.ctc_loss(lp.transpose(0, 1), lab, lens.long(), ulen,
                     blank=lp.shape[-1] - 1, reduction="none",
                     zero_infinity=False)
    return -nll.double().cpu().numpy()


def fusion_scores(lp, lens, answers: list, char_lm: dict, word_lm: dict,
                  dcfg: dict) -> np.ndarray:
    """The whole decode objective of each answer (see the module)."""
    texts = [ids_text(a) for a in answers]
    out = ctc_logp(lp, lens, answers)
    for i, t in enumerate(texts):
        out[i] += (dcfg["lm_weight"] * char_lm_score(char_lm, t)
                   + dcfg["word_bonus"] * t.count(" ")
                   + dcfg["rescore_alpha"] * word_lm_score(word_lm, t)
                   + dcfg["rescore_beta"] * len(t.split()))
    return out


@torch.no_grad()
def fusion_answers(lp, lens, char_lm: dict, word_lm: dict, dcfg: dict,
                   max_decode_len: int) -> list:
    """The reference's own answers: beam search with char-LM fusion over
    ``lp``, its N-best rescored with the word LM."""
    ids, nlens, scores = beam_ref.beam_search_decode(
        lp, lens, beam_width=dcfg["beam_width"], lm_table=char_lm["table"],
        lm_weight=dcfg["lm_weight"], word_bonus=dcfg["word_bonus"],
        init_ctx=0, lm_vocab=V, max_decode_len=max_decode_len,
        return_nbest=True)
    N = min(dcfg["nbest"], dcfg["beam_width"])
    ids, nlens, scores = (ids[:, :N].cpu().numpy(), nlens[:, :N].cpu().numpy(),
                          scores[:, :N].double().cpu().numpy())
    out = []
    for b in range(ids.shape[0]):
        best, best_s = 0, -np.inf
        for k in range(N):
            t = ids_text(ids[b, k, :nlens[b, k]])
            s = scores[b, k] + dcfg["rescore_alpha"] * word_lm_score(
                word_lm, t) + dcfg["rescore_beta"] * len(t.split())
            if s > best_s:
                best, best_s = k, s
        out.append([int(c) for c in ids[b, best, :nlens[b, best]]])
    return out
