"""Evaluation driver: params -> eval-manifest decode -> corpus WER/CER.

Counterpart of ``ctc_asr_tpu/evaluate.py`` and of
``train.make_eval_step``: samples -> features -> encoder -> greedy or
beam decode on the device (beam with optional char-LM fusion, and
word-LM N-best rescoring on the host), with the reference's
steady-state RTF accounting. In a formed ``torch.distributed`` group
each process decodes its own shard of the manifest and the
per-utterance records are gathered into one corpus
(``ctc_asr_tpu/evaluate.py:123-130``, ``:206-228``), under a model axis
too: each process evaluates its ``(rank, world)`` shard with the full
parameters, as the reference does. With ``mesh.seq_axis > 1`` (one
process) the encoder runs sequence-parallel (``parallel.seqpar``) and
the decoders take the gathered logits (``evaluate.py:133-148``).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from .config import Config
from .data import DataLoader, read_manifest
from .features import extract_features
from .metrics import ErrorRateAccumulator
from .models.encoder import apply_encoder
from .ops.dispatch import resolve_device
from .parallel import seqpar
from .parallel.dist import current_group, gather_records
from .text import decode_ids
from .train import check_regime, device_batches
from .utils.profiling import span

# the profiler ranges of the host's part of an N-best batch: the whole of
# ``pick_best``, and within it the B x N hypothesis texts
PICK_BEST_RANGE = "evaluate.pick_best"
NBEST_TEXTS_RANGE = "evaluate.nbest_texts"


def make_eval_step(cfg: Config, device: str | torch.device = "cuda"):
    """``(params, samples, slens) -> (logits, logit_lens)`` on ``device``.

    samples/slens may be numpy arrays (a loader batch) or tensors; they
    are moved to ``device`` first (nothing to move for the tensors that
    ``evaluate`` uploads ahead). Raises at once when ``device`` is CUDA
    and there is none."""
    dev = resolve_device(device)

    def eval_step(params, samples, sample_lengths):
        with torch.inference_mode():
            s = torch.as_tensor(samples).to(dev)
            sl = torch.as_tensor(sample_lengths).to(dev)
            feats, flens = extract_features(s, sl, cfg.features)
            return apply_encoder(params, feats, flens, cfg.model)

    return eval_step


def make_decoder(cfg: Config, return_nbest: bool = False):
    """``(logits, logit_lens) -> (ids, lens)`` for ``cfg.decode.method``
    (greedy, or beam with optional char-LM fusion); with
    ``return_nbest`` the beam decoder returns its whole beam best-first,
    ``(ids [B, K, U], lens [B, K], scores [B, K])``.

    ``decode.use_pallas`` selects the beam kernel (on a CUDA tensor; it
    launches or raises) or the plain PyTorch beam search."""
    if cfg.decode.method == "greedy":
        from .ops.greedy import greedy_decode
        return greedy_decode
    if cfg.decode.method == "beam":
        from .ops import beam as beam_mod
        lm = None
        if cfg.decode.lm_path:
            from .ops import lm as lm_mod
            lm = lm_mod.load_lm(cfg.decode.lm_path)
        return beam_mod.make_beam_decoder(
            beam_width=cfg.decode.beam_width, lm=lm,
            lm_weight=cfg.decode.lm_weight,
            word_bonus=cfg.decode.word_bonus,
            use_kernel=cfg.decode.use_pallas,
            max_decode_len=beam_mod.derive_max_decode_len(
                cfg.decode, cfg.data),
            return_nbest=return_nbest)
    raise ValueError(f"unknown decode method {cfg.decode.method!r}")


_SCORE_CACHE_MAX = 200_000


def make_nbest_decoder(cfg: Config):
    """``decode(logits, lens) -> (ids [B, N, U], lens [B, N], scores
    [B, N])`` with N = min(decode.nbest, beam_width), plus ``pick_best``,
    which rescores each utterance's N-best on the host with the word LM
    of ``decode.word_lm_path``."""
    from .ops import lm as lm_mod
    word_lm = lm_mod.load_word_lm(cfg.decode.word_lm_path)
    full_beam = make_decoder(cfg, return_nbest=True)
    N = min(cfg.decode.nbest, cfg.decode.beam_width)

    def decode(logits, logit_lens):
        ids, lens, scores = full_beam(logits, logit_lens)
        return ids[:, :N], lens[:, :N], scores[:, :N]

    # text -> word-LM log-prob, lives across batches. Bounded: one entry
    # per unique hypothesis string would otherwise grow without limit
    # over a large corpus; cross-batch hits come mostly from recent or
    # short hypotheses, so a flush loses little.
    score_cache: dict = {}

    def pick_best(ids, lens, scores):
        """Host: rescore each utterance's N-best, return numpy
        (ids [B, U], lens [B]). Duplicate hypotheses, within an N-best
        list and across the corpus, are scored once."""
        with span(PICK_BEST_RANGE):
            if len(score_cache) > _SCORE_CACHE_MAX:
                score_cache.clear()
            ids, lens, scores = (ids.cpu().numpy(), lens.cpu().numpy(),
                                 scores.cpu().numpy())
            B, N = ids.shape[0], ids.shape[1]
            with span(NBEST_TEXTS_RANGE):
                texts = [[decode_ids(ids[b, k, :lens[b, k]])
                          for k in range(N)] for b in range(B)]
            best = lm_mod.rescore_nbest_batch(
                texts, scores, word_lm, alpha=cfg.decode.rescore_alpha,
                beta=cfg.decode.rescore_beta, cache=score_cache)
            bidx = np.arange(B)
            return ids[bidx, best], lens[bidx, best]

    return decode, pick_best


def evaluate(cfg: Config, params, device: str | torch.device = "cuda",
             loader: DataLoader | None = None,
             max_batches: int | None = None, log_samples: int = 3,
             on_batch=None) -> dict:
    """Decode the eval manifest; returns the corpus metrics summary.

    ``rtf`` is wall time per second of audio over every batch except
    the first of each length bucket (which pays first-call costs);
    ``rtf_incl_compile`` includes them. Raises for what the reference
    refuses (``train.check_regime``).

    In a formed group every process calls it: each decodes its strided
    shard (every utterance once, ``drop_last=False``), and the corpus
    metrics, the bootstrap CI and ``per_utt`` describe the whole corpus,
    its records in process-major order (rank 0's shard first, ROADMAP.md
    C2); the times and ``audio_seconds`` stay this process's.

    ``on_batch(batch, logits, logit_lens, hyps)``, when given, sees each
    batch's encoder output and the hypotheses of its valid rows
    (``scripts/diag_oov_boundaries``)."""
    mesh = check_regime(cfg)
    if cfg.mesh.seq_axis > 1:
        eval_step = seqpar.make_sp_eval_step(
            cfg, seqpar.sp_devices(cfg.mesh.seq_axis, device))
    else:
        eval_step = make_eval_step(cfg, device)
    if loader is None:
        # by process, not by data row: every process decodes its own
        # utterances with the full parameters, under a model axis too
        loader = DataLoader(read_manifest(cfg.data.eval_manifest), cfg.data,
                            cfg.features, shard_idx=mesh.rank,
                            num_shards=mesh.world, drop_last=False)
    rescorer = None
    if cfg.decode.word_lm_path and cfg.decode.method == "beam":
        decoder, rescorer = make_nbest_decoder(cfg)
    else:
        decoder = make_decoder(cfg)
    acc = ErrorRateAccumulator()
    total_audio = 0.0
    t0 = time.perf_counter()
    t_prev = t0
    steady_wall, steady_audio = 0.0, 0.0
    seen_buckets: set = set()
    shown = 0
    src = loader.iter_epoch(0)
    if max_batches is not None:
        # cap BEFORE the upload prefetch: nothing past the cap is read or
        # uploaded
        src = itertools.islice(src, max_batches)
    for batch, (d_samples, d_slens) in device_batches(
            src, None, resolve_device(device), with_labels=False):
        logits, logit_lens = eval_step(params, d_samples, d_slens)
        # the copy to the host waits for the device: a true barrier
        if rescorer is not None:
            ids, lens = rescorer(*decoder(logits, logit_lens))
        else:
            ids, lens = decoder(logits, logit_lens)
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        hyps = [decode_ids(ids[i, :lens[i]]) for i in range(batch.valid)]
        for ref, hyp in zip(batch.transcripts, hyps):
            acc.add(ref, hyp)
            if shown < log_samples:
                print(f"[eval] ref: {ref!r}\n[eval] hyp: {hyp!r}",
                      flush=True)
                shown += 1
        if on_batch is not None:
            on_batch(batch, logits, logit_lens, hyps)
        total_audio += batch.audio_seconds
        now = time.perf_counter()
        if batch.bucket_id in seen_buckets:
            steady_wall += now - t_prev
            steady_audio += batch.audio_seconds
        else:
            seen_buckets.add(batch.bucket_id)
        t_prev = now
    wall = time.perf_counter() - t0
    group = current_group()
    if group is not None:
        merged = ErrorRateAccumulator()
        for rec in gather_records(acc.utt_records, group):
            merged.add_record(*rec)
        acc = merged
    out = acc.summary()
    out.update(acc.bootstrap_ci())
    out["per_utt"] = list(acc.utt_records)
    out["rtf"] = (steady_wall / steady_audio if steady_audio > 0
                  else wall / max(total_audio, 1e-9))
    out["rtf_incl_compile"] = wall / max(total_audio, 1e-9)
    out["audio_seconds"] = total_audio
    out["wall_seconds"] = wall
    dev = resolve_device(device)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out
