"""Greedy (best-path) CTC decoding, vectorized on the device.

Counterpart of ``ctc_asr_tpu/ops/greedy.py``: argmax -> collapse
repeats -> drop blanks, as a masked cumsum + scatter over the batch.
"""

from __future__ import annotations

import torch

from ..text import BLANK_ID, PAD_ID


def greedy_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                  blank_id: int = BLANK_ID, pad_id: int = PAD_ID):
    """[B, T, C] logits -> (ids [B, T] padded with pad_id, lengths [B]).

    Ties in the argmax take the first class, as ``jnp.argmax`` does."""
    B, T, _ = logits.shape
    dev = logits.device
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    valid = torch.arange(T, device=dev)[None, :] < logit_lengths[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev),
                      ids[:, :-1]], dim=1)
    keep = valid & (ids != blank_id) & (ids != prev)
    # kept ids go to their exclusive-cumsum column; dropped ones all go
    # to the spill column T, which is cut off
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, T)
    out = torch.full((B, T + 1), pad_id, dtype=torch.int32, device=dev)
    out.scatter_(1, pos.long(), ids)
    return out[:, :T], keep.sum(dim=1).to(torch.int32)
