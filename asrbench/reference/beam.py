"""Plain CTC prefix beam search with char-LM shallow fusion: a frozen
copy of the port's plain version (``ctc_asr_tpu_torch/ops/beam.py``
``beam_search_decode`` and ``backtrack``), which is also the
specification its CUDA kernel follows. Kept here so that a later change
to the program cannot move the reference; it imports nothing of the port.

Blank is the last class; a ranking score is log P_ctc + lm_weight *
log P_lm + word_bonus * (spaces in the prefix); identical prefixes are
merged through two rolling 32-bit hashes; ties in score go by the first
hash, then by candidate index.
"""

from __future__ import annotations

import torch

BLANK_ID = 28
PAD_ID = 28

NEG = -1.0e30
_DEAD = NEG / 2

# Rolling-hash constants (two independent 32-bit lanes ~ one 64-bit hash);
# int64 arithmetic masked to 32 bits wraps like the reference's uint32.
_MASK = 0xFFFFFFFF
_H1_MUL, _H1_ADD, _H1_SEED = 1000003, 0x9E3779B9, 17
_H2_MUL, _H2_ADD, _H2_SEED = 69069, 0x85EBCA6B, 29


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.clamp_min(torch.maximum(a, b), NEG)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def _sort_key(score: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    """int64 key whose descending order is (score desc, h1 asc): the f32
    bits mapped to a monotone unsigned 32-bit integer (negatives,
    positives and -1e30 alike; -0 folded into +0), shifted into the
    signed range, above the inverted hash."""
    bits = (score + 0.0).view(torch.int32).long() & _MASK
    mono = torch.where(bits >= 1 << 31, ~bits & _MASK, bits | (1 << 31))
    return ((mono - (1 << 31)) << 32) + (_MASK - h1)


def decode_buffer_len(T: int, max_decode_len: int | None) -> int:
    """U: CTC emits at most one char per frame, so min(max_decode_len, T)
    is exact, not a cap; without ``max_decode_len`` it is min(T, 256)."""
    return min(max_decode_len, max(T, 1)) if max_decode_len else min(T, 256)


def padded_lm_table(lm_table, n_chars: int, device) -> torch.Tensor:
    """[n_ctx, V] table -> f32 [n_ctx, n_chars] on ``device``, zero
    columns for characters beyond the LM's vocabulary."""
    table = torch.as_tensor(lm_table, dtype=torch.float32, device=device)
    n_ctx, V = table.shape
    if V > n_chars:
        raise ValueError(f"LM vocab {V} exceeds non-blank classes {n_chars}")
    if V < n_chars:
        table = torch.cat([table, table.new_zeros(n_ctx, n_chars - V)], 1)
    return table.contiguous()


def backtrack(parents: torch.Tensor, chars: torch.Tensor, start: torch.Tensor,
              full_len: torch.Tensor, U: int):
    """Rebuild prefixes from per-step (parent, char) records.

    parents / chars [T, B, K] (char -1 = stay), start [B, N] beam indices
    after the last step, full_len [B, N] their unclamped lengths ->
    (ids [B, N, U] int32 padded with PAD_ID, lengths [B, N] int32)."""
    T = parents.shape[0]
    B, N = start.shape
    ids = torch.full((B, N, U + 1), PAD_ID, dtype=torch.int32,
                     device=start.device)
    j = start
    pos = full_len.clone()
    for t in range(T - 1, -1, -1):
        c = chars[t].gather(1, j)
        ext = c >= 0
        pos = pos - ext.long()
        # characters at positions >= U and stay records go to the spill
        # column U, which is cut off
        col = torch.where(ext & (pos < U), pos, torch.full_like(pos, U))
        ids.scatter_(2, col[:, :, None], c.to(torch.int32)[:, :, None])
        j = parents[t].gather(1, j)
    return (ids[:, :, :U].contiguous(),
            torch.clamp_max(full_len, U).to(torch.int32))


def beam_search_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                       beam_width: int = 64, blank_id: int = BLANK_ID,
                       space_id: int = 0, lm_table=None,
                       lm_weight: float = 0.0, word_bonus: float = 0.0,
                       init_ctx: int = 0, lm_vocab: int = 28,
                       max_decode_len: int | None = None,
                       return_nbest: bool = False):
    """[B, T, C] logits -> (ids [B, U] int32, lengths [B] int32), or with
    ``return_nbest`` the whole beam best-first
    (ids [B, K, U], lengths [B, K], scores [B, K] f32) for host-side
    N-best rescoring.

    ``lm_table`` is a dense ``[n_ctx, V]`` array of char-LM log-probs;
    the context id updates as ``(ctx * lm_vocab + c) % n_ctx``. Runs on
    the device of ``logits``."""
    B, T, C = logits.shape
    if blank_id != C - 1:
        raise ValueError("beam search assumes blank is the last class")
    K, Cr = beam_width, C - 1
    dev = logits.device
    U = decode_buffer_len(T, max_decode_len)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    lens = logit_lengths.to(dev).long()
    if lm_table is not None:
        table = padded_lm_table(lm_table, Cr, dev)
        lookup, n_ctx = table.__getitem__, table.shape[0]
    else:
        lookup, n_ctx = None, 1

    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    neg = torch.full((B, K), NEG, **f32)
    pb = neg.clone()
    pb[:, 0] = 0.0
    pnb = neg.clone()
    last = torch.full((B, K), -1, **i64)
    h1 = torch.full((B, K), _H1_SEED, **i64)
    h2 = torch.full((B, K), _H2_SEED, **i64)
    ctx = torch.full((B, K), init_ctx, **i64)
    lm = torch.zeros((B, K), **f32)
    bon = torch.zeros((B, K), **f32)
    flen = torch.zeros((B, K), **i64)

    chars = torch.arange(Cr, device=dev)
    is_space = (chars == space_id).float()[None, None, :]
    beam_idx = torch.arange(K, device=dev)[None, :].expand(B, K)
    parents = torch.empty((T, B, K), **i64)
    back_chars = torch.empty((T, B, K), **i64)

    for t in range(T):
        lp = log_probs[:, t]                                  # [B, C]
        valid = (t < lens)[:, None]                           # [B, 1]
        total = _logaddexp(pb, pnb)
        last_c = torch.clamp_min(last, 0)

        # ---- stay candidates (one per beam) ---------------------------
        stay_pb = total + lp[:, blank_id:blank_id + 1]
        stay_pnb = torch.where(last >= 0, pnb + lp.gather(1, last_c), neg)
        stay_live = (stay_pb > _DEAD) | (stay_pnb > _DEAD)

        # ---- extend candidates [B, K, Cr] -----------------------------
        is_repeat = chars[None, None, :] == last[:, :, None]
        ext_pnb = torch.where(is_repeat, pb[:, :, None], total[:, :, None]) \
            + lp[:, None, :Cr]
        ext_live = ext_pnb > _DEAD

        # ---- merge: stay(k) with extend(j, last_k), rows k, cols j ----
        c_k = last_c[:, :, None]
        h1_ext = (h1[:, None, :] * _H1_MUL + (c_k + _H1_ADD)) & _MASK
        h2_ext = (h2[:, None, :] * _H2_MUL + (c_k + _H2_ADD)) & _MASK
        col_of_k = last_c[:, None, :].expand(B, K, K)   # [b, j, k] -> last_k
        val = ext_pnb.gather(2, col_of_k).transpose(1, 2)     # [b, k, j]
        match = ((h1_ext == h1[:, :, None]) & (h2_ext == h2[:, :, None])
                 & ((last >= 0) & stay_live)[:, :, None] & (val > _DEAD))
        merged_in = torch.where(match, val, torch.full_like(val, NEG)) \
            .max(dim=2).values
        stay_pnb = torch.where(match.any(dim=2),
                               _logaddexp(stay_pnb, merged_in), stay_pnb)
        # extend (j, c) leaves the ranking iff some stay k with last_k = c
        # absorbed it
        killed = torch.zeros((B, K, Cr), dtype=torch.int32, device=dev)
        killed.scatter_add_(2, col_of_k,
                            match.transpose(1, 2).to(torch.int32))

        # ---- ranking scores -------------------------------------------
        if lookup is not None:
            ext_lm = lm[:, :, None] + lookup(ctx)
            ext_ctx = (ctx[:, :, None] * lm_vocab + chars[None, None, :]) \
                % n_ctx
        else:
            ext_lm = lm[:, :, None].expand(B, K, Cr)
            ext_ctx = ctx[:, :, None].expand(B, K, Cr)
        ext_bon = bon[:, :, None] + is_space
        stay_score = _logaddexp(stay_pb, stay_pnb) + lm_weight * lm \
            + word_bonus * bon
        stay_score = torch.where(stay_live, stay_score, neg)
        # an extend has p_b = NEG, so its acoustic total is ext_pnb itself
        ext_score = ext_pnb + lm_weight * ext_lm + word_bonus * ext_bon
        ext_score = torch.where(ext_live & (killed == 0), ext_score,
                                torch.full_like(ext_score, NEG))
        # the stay sits in the blank column (blank is the last class)
        cand = torch.cat([ext_score, stay_score[:, :, None]], dim=2) \
            .reshape(B, K * C)

        # ---- top-K: score desc, hash asc, flat candidate index asc ----
        cand_h1 = torch.cat(
            [(h1[:, :, None] * _H1_MUL + (chars[None, None, :] + _H1_ADD))
             & _MASK, h1[:, :, None]], dim=2).reshape(B, K * C)
        order = torch.sort(_sort_key(cand, cand_h1), dim=1, descending=True,
                           stable=True).indices
        top = order[:, :K]
        top_s = cand.gather(1, top)
        parent = top // C
        is_stay = top % C == blank_id
        char = torch.where(is_stay, torch.full_like(top, -1), top % C)
        e = parent * Cr + torch.clamp_max(top % C, Cr - 1)   # [K, Cr] index
        dead = top_s <= _DEAD

        def pick(stay_vals, ext_vals):
            return torch.where(is_stay, stay_vals.gather(1, parent),
                               ext_vals.reshape(B, K * Cr).gather(1, e))

        n_pb = torch.where(is_stay & ~dead, stay_pb.gather(1, parent), neg)
        n_pnb = torch.where(dead, neg, pick(stay_pnb, ext_pnb))
        n_last = torch.where(is_stay, last.gather(1, parent), char)
        p_h1, p_h2 = h1.gather(1, parent), h2.gather(1, parent)
        n_h1 = torch.where(is_stay, p_h1,
                           (p_h1 * _H1_MUL + (char + _H1_ADD)) & _MASK)
        n_h2 = torch.where(is_stay, p_h2,
                           (p_h2 * _H2_MUL + (char + _H2_ADD)) & _MASK)
        n_ctx_id = pick(ctx, ext_ctx)
        n_lm = pick(lm, ext_lm)
        n_bon = pick(bon, ext_bon)
        n_flen = flen.gather(1, parent) + (~is_stay).long()

        # ---- commit; frames past logit_len leave the beam untouched ---
        pb = torch.where(valid, n_pb, pb)
        pnb = torch.where(valid, n_pnb, pnb)
        last = torch.where(valid, n_last, last)
        h1 = torch.where(valid, n_h1, h1)
        h2 = torch.where(valid, n_h2, h2)
        ctx = torch.where(valid, n_ctx_id, ctx)
        lm = torch.where(valid, n_lm, lm)
        bon = torch.where(valid, n_bon, bon)
        flen = torch.where(valid, n_flen, flen)
        parents[t] = torch.where(valid, parent, beam_idx)
        back_chars[t] = torch.where(valid, char, torch.full_like(char, -1))

    score = _logaddexp(pb, pnb) + lm_weight * lm + word_bonus * bon
    score, order = torch.sort(score, dim=1, descending=True, stable=True)
    if not return_nbest:
        order = order[:, :1]
    ids, out_lens = backtrack(parents, back_chars, order,
                              flen.gather(1, order), U)
    if return_nbest:
        return ids, out_lens, score
    return ids[:, 0], out_lens[:, 0]


