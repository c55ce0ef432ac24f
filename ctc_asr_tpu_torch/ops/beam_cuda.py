"""Wrapper of the CUDA beam-search kernel ``csrc/beam.cu`` (K8).

Counterpart of ``ctc_asr_tpu/ops/beam_pallas.py``
(``beam_search_decode_pallas`` around ``_beam_kernel``), with the same
surface. The plain version is ``ops/beam.py``'s ``beam_search_decode``
(re-exported here as ``beam_search_decode_plain``): a CPU tensor gets
it, a CUDA tensor launches the kernel or raises.

``log_softmax`` before the kernel and the best-first sort of the N-best
list after it stay in torch, as they stay outside the Pallas kernel in
the reference. The wrapper allocates the outputs and the
``[B, T, K]`` back-pointer scratch from which the kernel rebuilds the
emitted prefixes. The limits of the reference's kernel that came from
VMEM are gone: the decode buffer U has no cap, and the LM table is f32
in device memory at any order.
"""

from __future__ import annotations

import torch

from ..text import BLANK_ID, PAD_ID
from . import build
from .beam import beam_search_decode as beam_search_decode_plain
from .beam import _sort_key, decode_buffer_len, padded_lm_table
from .dispatch import check_kernel_tensor, require_kernel_device

MAX_BEAM = 512          # a block's threads pick the beams and prefetch
MAX_CLASSES = 255       # a back-pointer record keeps char + 1 in 8 bits
MAX_SORT_KEYS = 16384   # 128 KB of 64-bit sort keys in shared memory


def sort_width(beam_width: int, num_classes: int) -> int:
    """Candidates per step, K*C, padded to a power of two (>= 64)."""
    n = max(64, beam_width * num_classes)
    return 1 << (n - 1).bit_length()


def select_top_k_probe(scores: torch.Tensor, h1: torch.Tensor, k: int):
    """K8's top-K selection alone, in one block on the card (the C entry
    ``beam_select_probe``; the decode path never calls it): candidate i
    has score ``scores[i]`` (f32) and first hash ``h1[i]`` (uint32 bits in
    int32). Returns the k best as (keys, indices), int64, in rank order:
    ``ops.beam._sort_key`` descending, the index ascending among equal
    keys. A CPU tensor gets that order from a stable ``torch.sort``."""
    return _select_probe(scores, h1, k)


def _select_probe(scores: torch.Tensor, h1: torch.Tensor, k: int,
                  reps: int = 1, select: bool = True):
    """``select_top_k_probe`` with the knobs that time the selection on
    the card: ``reps`` repeats the fill of the keys and the selection
    inside the one launch, and ``select=False`` leaves the selection out
    (the outputs are then not the k best)."""
    n = scores.shape[0]
    NP = sort_width(1, n)
    if not 1 <= k <= min(n, MAX_BEAM) or NP > MAX_SORT_KEYS or reps < 1:
        raise ValueError(f"the selection takes 1 <= k <= min(n, {MAX_BEAM})"
                         f", n <= {MAX_SORT_KEYS} and reps >= 1, got k={k},"
                         f" n={n}, reps={reps}")
    if scores.device.type == "cpu":
        keys = _sort_key(scores, h1.long() & 0xFFFFFFFF)
        keys, order = torch.sort(keys, descending=True, stable=True)
        return keys[:k], order[:k]
    check_kernel_tensor("scores", scores, torch.float32, (n,))
    check_kernel_tensor("h1", h1, torch.int32, (n,))
    require_kernel_device(scores)
    keys = torch.empty(k, dtype=torch.int64, device=scores.device)
    flat = torch.empty(k, dtype=torch.int32, device=scores.device)
    rc = build.load().beam_select_probe(
        scores.data_ptr(), h1.data_ptr(), n, k, NP, int(reps), int(select),
        keys.data_ptr(), flat.data_ptr(),
        torch.cuda.current_stream(scores.device).cuda_stream)
    build.check(rc, "beam_select_probe")
    # the kernel's unsigned key, less 2**63, is _sort_key's signed one
    return keys ^ torch.iinfo(torch.int64).min, flat.long()


def beam_search_decode_cuda(logits: torch.Tensor, logit_lengths: torch.Tensor,
                            beam_width: int = 64, blank_id: int = BLANK_ID,
                            max_decode_len: int | None = None,
                            lm_table=None, lm_weight: float = 0.0,
                            word_bonus: float = 0.0, init_ctx: int = 0,
                            lm_vocab: int = 28, space_id: int = 0,
                            return_nbest: bool = False):
    """[B, T, C] logits -> (ids [B, U] int32, lengths [B] int32), or with
    ``return_nbest`` the whole beam best-first
    (ids [B, K, U], lengths [B, K], scores [B, K]) — the surface of
    ``ops.beam.beam_search_decode``. A CPU tensor gets the plain
    version; a CUDA tensor launches K8 (and raises if it cannot). A
    CUDA batch of no rows has no block to launch and gets the empty
    outputs; rows of no frames (T = 0) go through the kernel."""
    if logits.device.type == "cpu":
        return beam_search_decode_plain(
            logits, logit_lengths, beam_width=beam_width, blank_id=blank_id,
            space_id=space_id, lm_table=lm_table, lm_weight=lm_weight,
            word_bonus=word_bonus, init_ctx=init_ctx, lm_vocab=lm_vocab,
            max_decode_len=max_decode_len, return_nbest=return_nbest)
    require_kernel_device(logits)
    B, T, C = logits.shape
    K = int(beam_width)
    if blank_id != C - 1:
        raise ValueError("the beam kernel assumes blank is the last class")
    if not 1 <= K <= MAX_BEAM:
        raise ValueError("the beam kernel takes a beam width of "
                         f"1..{MAX_BEAM}, got {K}")
    if not 2 <= C <= MAX_CLASSES:
        raise ValueError(f"the beam kernel takes 2..{MAX_CLASSES} classes, "
                         f"got {C}")
    NP = sort_width(K, C)
    if NP > MAX_SORT_KEYS:
        raise ValueError(
            f"beam_width * classes = {K * C} exceeds the beam kernel's "
            f"{MAX_SORT_KEYS} sort keys")
    dev = logits.device
    U = decode_buffer_len(T, max_decode_len)
    kout = K if return_nbest else 1

    log_probs = torch.log_softmax(logits.float(), dim=-1).contiguous()
    lens = logit_lengths.to(device=dev, dtype=torch.int32).contiguous()
    check_kernel_tensor("log_probs", log_probs, torch.float32, (B, T, C))
    check_kernel_tensor("logit_lengths", lens, torch.int32, (B,))
    table_ptr, n_ctx = None, 1
    if lm_table is not None:
        table = padded_lm_table(lm_table, C - 1, dev)
        n_ctx = table.shape[0]
        check_kernel_tensor("lm_table", table, torch.float32, (n_ctx, C - 1))
        if not 0 <= init_ctx < n_ctx:
            raise ValueError(f"init_ctx {init_ctx} outside the LM table's "
                             f"{n_ctx} contexts")
        table_ptr = table.data_ptr()

    ids = torch.full((B, kout, U), PAD_ID, dtype=torch.int32, device=dev)
    out_lens = torch.zeros((B, kout), dtype=torch.int32, device=dev)
    scores = torch.empty((B, kout), dtype=torch.float32, device=dev)
    back = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    if B > 0:
        rc = build.load().beam_search(
            log_probs.data_ptr(), lens.data_ptr(), table_ptr, back.data_ptr(),
            ids.data_ptr(), out_lens.data_ptr(), scores.data_ptr(), B, T, C,
            K, U, NP, n_ctx, int(lm_vocab), int(space_id), int(init_ctx),
            float(lm_weight), float(word_bonus), int(return_nbest),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "beam_search")
        beam_search_decode_cuda.launches += 1
    if not return_nbest:
        return ids[:, 0], out_lens[:, 0]
    # the kernel emits the beam in beam order; best-first is a stable sort
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    ids = ids.gather(1, order[:, :, None].expand(B, K, U))
    return ids, out_lens.gather(1, order), scores


beam_search_decode_cuda.launches = 0
