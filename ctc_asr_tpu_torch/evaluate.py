"""Evaluation driver: params -> eval-manifest decode -> corpus WER/CER.

Counterpart of ``ctc_asr_tpu/evaluate.py`` (single process) and of
``train.make_eval_step``: samples -> features -> encoder -> greedy
decode on the device, with the reference's steady-state RTF
accounting.
"""

from __future__ import annotations

import time

import torch

from ctc_asr_tpu.config import Config
from ctc_asr_tpu.data import DataLoader, read_manifest
from ctc_asr_tpu.metrics import ErrorRateAccumulator
from ctc_asr_tpu.text import decode_ids

from .features import extract_features
from .models.encoder import apply_encoder
from .ops.dispatch import resolve_device


def make_eval_step(cfg: Config, device: str | torch.device = "cuda"):
    """``(params, samples, slens) -> (logits, logit_lens)`` on ``device``.

    samples/slens may be numpy arrays (a loader batch) or tensors; they
    are moved to ``device`` first. Raises at once when ``device`` is
    CUDA and there is none."""
    dev = resolve_device(device)

    def eval_step(params, samples, sample_lengths):
        with torch.inference_mode():
            s = torch.as_tensor(samples).to(dev)
            sl = torch.as_tensor(sample_lengths).to(dev)
            feats, flens = extract_features(s, sl, cfg.features)
            return apply_encoder(params, feats, flens, cfg.model)

    return eval_step


def make_decoder(cfg: Config):
    """``(logits, logit_lens) -> (ids, lens)`` for ``cfg.decode.method``."""
    if cfg.decode.method == "greedy":
        from .ops.greedy import greedy_decode
        return greedy_decode
    if cfg.decode.method == "beam":
        raise NotImplementedError(
            "beam decoding is not ported yet: it waits for the beam kernel "
            "(ROADMAP.md, B: K8 beam_pallas._beam_kernel)")
    raise ValueError(f"unknown decode method {cfg.decode.method!r}")


def evaluate(cfg: Config, params, device: str | torch.device = "cuda",
             loader: DataLoader | None = None,
             max_batches: int | None = None, log_samples: int = 3) -> dict:
    """Decode the eval manifest; returns the corpus metrics summary.

    ``rtf`` is wall time per second of audio over every batch except
    the first of each length bucket (which pays first-call costs);
    ``rtf_incl_compile`` includes them."""
    if loader is None:
        loader = DataLoader(read_manifest(cfg.data.eval_manifest), cfg.data,
                            cfg.features, drop_last=False)
    eval_step = make_eval_step(cfg, device)
    decoder = make_decoder(cfg)
    acc = ErrorRateAccumulator()
    total_audio = 0.0
    t0 = time.perf_counter()
    t_prev = t0
    steady_wall, steady_audio = 0.0, 0.0
    seen_buckets: set = set()
    shown = 0
    for bi, batch in enumerate(loader.iter_epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        logits, logit_lens = eval_step(params, batch.samples,
                                       batch.sample_lengths)
        ids, lens = decoder(logits, logit_lens)
        # the copy to the host waits for the device: a true barrier
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        for i in range(batch.valid):
            hyp = decode_ids(ids[i, :lens[i]])
            ref = batch.transcripts[i]
            acc.add(ref, hyp)
            if shown < log_samples:
                print(f"[eval] ref: {ref!r}\n[eval] hyp: {hyp!r}",
                      flush=True)
                shown += 1
        total_audio += batch.audio_seconds
        now = time.perf_counter()
        if batch.bucket_id in seen_buckets:
            steady_wall += now - t_prev
            steady_audio += batch.audio_seconds
        else:
            seen_buckets.add(batch.bucket_id)
        t_prev = now
    wall = time.perf_counter() - t0
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
