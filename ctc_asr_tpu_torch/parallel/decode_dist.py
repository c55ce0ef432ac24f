"""Distributed beam decode with the char-LM table row-sharded over 'model'.

Counterpart of ``ctc_asr_tpu/parallel/decode_dist.py``. The batch
shards over 'data' (each rank of a model group decodes the same
utterances); the dense char-LM table ``[n_ctx, V]`` is row-sharded over
the model group, so each rank holds ``n_ctx / model`` rows. At every
frame step of the beam search the K live contexts of each utterance
need their rows: each rank gathers the rows it owns and zeros the
others, and one ``all_reduce(SUM)`` of [B, K, V] over the model group
assembles the block. Adding zeros is exact, so the ids equal those of
the replicated-table decoder. The search is the plain
``ops.beam.beam_search_decode`` with the lookup as its callable table,
as the reference runs its pure-JAX beam search there
(``decode_dist.py:443-447``); the beam kernel takes a dense table only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import Config
from ..ops import beam as beam_mod
from ..ops import lm as lm_mod


def sharded_lm_lookup(table_local: torch.Tensor, ctx: torch.Tensor,
                      rank: int, rows_per_shard: int,
                      group) -> torch.Tensor:
    """ctx [...] global context ids -> [..., V] LM rows, assembled by one
    ``all_reduce`` over ``group`` (``_sharded_lm_lookup``).
    ``table_local`` is this rank's [rows_per_shard, V] slice."""
    local = ctx - rank * rows_per_shard
    owned = (local >= 0) & (local < rows_per_shard)
    rows = table_local[torch.clamp(local, 0, rows_per_shard - 1)]
    rows = torch.where(owned[..., None], rows, torch.zeros_like(rows))
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    return rows


def make_sharded_lm_beam_decoder(cfg: Config, group, lm: dict):
    """``(decode, place_table)`` (``make_sharded_lm_beam_decoder``):

    - ``place_table(device)`` puts this rank's rows of the table, at
      ``padded_lm_table``'s width (one column a non-blank class of
      ``cfg.model``), on ``device`` and returns them (callers do this
      once);
    - ``decode(logits, logit_lens, table) -> (ids, lens)`` runs the beam
      search of ``cfg.decode`` with the row-sharded lookup. Every rank
      of ``group`` (the model group) calls it on the same batch.

    Raises when the table's rows do not split over the group."""
    order = int(lm["order"])
    init_ctx = lm_mod.initial_context(order)
    n_ctx = lm["table"].shape[0]
    n_model = dist.get_world_size(group)
    if n_ctx % n_model != 0:
        raise ValueError(f"LM rows {n_ctx} not divisible by model axis "
                         f"{n_model}")
    rows_per = n_ctx // n_model
    rank = dist.get_rank(group)
    dcfg = cfg.decode

    def place_table(device):
        rows = lm["table"][rank * rows_per:(rank + 1) * rows_per]
        return beam_mod.padded_lm_table(rows, cfg.model.num_classes - 1,
                                        device)

    def decode(logits, logit_lens, table):
        def lookup(ctx):
            return sharded_lm_lookup(table, ctx, rank, rows_per, group)
        return beam_mod.beam_search_decode(
            logits, logit_lens, beam_width=dcfg.beam_width,
            lm_table=lookup, lm_weight=dcfg.lm_weight,
            word_bonus=dcfg.word_bonus, init_ctx=init_ctx,
            lm_vocab=lm_mod.V, lm_ctx_size=n_ctx)

    return decode, place_table
