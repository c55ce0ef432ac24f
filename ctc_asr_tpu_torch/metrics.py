"""Text metrics (WER / CER / Levenshtein) and training observability.

The port's own copy of ``ctc_asr_tpu/metrics.py``: WER and character
edit distance via Levenshtein with corpus-level averaging, bootstrap
intervals and the paired bootstrap, the throughput meter
(audio-seconds/s, RTF) and the JSONL + TensorBoard metrics sink.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np


def levenshtein(a, b) -> int:
    """Edit distance between two sequences (str, list, or 1-D array)."""
    a, b = list(a), list(b)
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    cur = np.empty_like(prev)
    for i, ca in enumerate(a, start=1):
        cur[0] = i
        for j, cb in enumerate(b, start=1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev, cur = cur, prev
    return int(prev[len(b)])


def wer(ref: str, hyp: str) -> float:
    """Word error rate for one utterance (edit distance over ref words)."""
    ref_words = ref.split()
    hyp_words = hyp.split()
    if not ref_words:
        return 0.0 if not hyp_words else 1.0
    return levenshtein(ref_words, hyp_words) / len(ref_words)


def cer(ref: str, hyp: str) -> float:
    """Character error rate for one utterance."""
    if not ref:
        return 0.0 if not hyp else 1.0
    return levenshtein(ref, hyp) / len(ref)


@dataclass
class ErrorRateAccumulator:
    """Corpus-level WER/CER: sums edit distances and token counts, then
    divides once — the standard corpus WER definition (not mean-of-rates).

    Also keeps the per-utterance (edits, counts) so corpus WER/CER can
    carry a bootstrap confidence interval (the WER table's
    adjacent rows must be distinguishable from sampling noise).
    """

    word_edits: int = 0
    word_count: int = 0
    char_edits: int = 0
    char_count: int = 0
    utterances: int = 0
    utt_records: list = field(default_factory=list)  # (we, wc, ce, cc)

    def add(self, ref: str, hyp: str) -> None:
        rw, hw = ref.split(), hyp.split()
        we, ce = levenshtein(rw, hw), levenshtein(ref, hyp)
        self.word_edits += we
        self.word_count += len(rw)
        self.char_edits += ce
        self.char_count += len(ref)
        self.utterances += 1
        self.utt_records.append((we, len(rw), ce, len(ref)))

    def add_record(self, we: int, wc: int, ce: int, cc: int) -> None:
        """Accumulate an already-computed per-utterance record — the
        cross-process merge path (evaluate() allgathers each shard's
        utt_records so CIs/per_utt dumps describe the whole corpus)."""
        self.word_edits += we
        self.word_count += wc
        self.char_edits += ce
        self.char_count += cc
        self.utterances += 1
        self.utt_records.append((we, wc, ce, cc))

    def bootstrap_ci(self, n_resamples: int = 2000, seed: int = 0) -> dict:
        """Percentile-bootstrap 95% CI on corpus WER and CER.

        Resamples utterances with replacement (the exchangeable unit for
        corpus error rates) and recomputes the ratio-of-sums statistic per
        resample. Deterministic for a fixed seed. Returns {} when fewer
        than two utterances were accumulated.
        """
        n = self.utterances
        if n < 2:
            return {}
        rec = np.asarray(self.utt_records, dtype=np.int64)  # [n, 4]
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, n, size=(n_resamples, n))
        sums = rec[idx].sum(axis=1)  # [n_resamples, 4]
        wers = sums[:, 0] / np.maximum(1, sums[:, 1])
        cers = sums[:, 2] / np.maximum(1, sums[:, 3])
        lo, hi = 2.5, 97.5
        return {
            "wer_ci95": [float(np.percentile(wers, lo)),
                         float(np.percentile(wers, hi))],
            "cer_ci95": [float(np.percentile(cers, lo)),
                         float(np.percentile(cers, hi))],
        }

    @property
    def wer(self) -> float:
        return self.word_edits / max(1, self.word_count)

    @property
    def cer(self) -> float:
        return self.char_edits / max(1, self.char_count)

    def summary(self) -> dict:
        return {
            "wer": self.wer,
            "cer": self.cer,
            "utterances": self.utterances,
            "word_edits": self.word_edits,
            "word_count": self.word_count,
        }


def paired_bootstrap(records_a, records_b, n_resamples: int = 2000,
                     seed: int = 0) -> dict:
    """Paired bootstrap comparison of two systems on the SAME test set.

    ``records_a`` / ``records_b`` are per-utterance ``(we, wc, ce, cc)``
    tuples aligned by utterance (``ErrorRateAccumulator.utt_records`` from
    two evals of the same manifest in the same order). Resamples utterance
    indices once per replicate and applies them to both systems, so shared
    utterance difficulty cancels — the standard significance test for WER
    deltas (far tighter than comparing two independent CIs).

    Returns the observed corpus-WER delta (A − B), its 95% CI, and
    ``p_a_better`` = fraction of replicates where A's corpus WER is lower.
    """
    ra = np.asarray(records_a, dtype=np.int64)
    rb = np.asarray(records_b, dtype=np.int64)
    if ra.shape != rb.shape or ra.shape[0] < 2:
        raise ValueError(f"need aligned records, got {ra.shape} vs {rb.shape}")
    n = ra.shape[0]
    delta = (ra[:, 0].sum() / max(1, ra[:, 1].sum())
             - rb[:, 0].sum() / max(1, rb[:, 1].sum()))
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_resamples, n))
    sa, sb = ra[idx].sum(axis=1), rb[idx].sum(axis=1)
    deltas = (sa[:, 0] / np.maximum(1, sa[:, 1])
              - sb[:, 0] / np.maximum(1, sb[:, 1]))
    return {
        "wer_delta": float(delta),
        "wer_delta_ci95": [float(np.percentile(deltas, 2.5)),
                           float(np.percentile(deltas, 97.5))],
        "p_a_better": float(np.mean(deltas < 0)),
    }


@dataclass
class ThroughputMeter:
    """audio-seconds/s (the train throughput metric).

    Counts *real* (unpadded) audio seconds so padding waste shows up as a
    throughput loss rather than being hidden.
    """

    window: int = 50
    _events: list = field(default_factory=list)

    def update(self, audio_seconds: float) -> None:
        self._events.append((time.perf_counter(), audio_seconds))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def audio_seconds_per_second(self) -> float:
        if len(self._events) < 2:
            return 0.0
        t0 = self._events[0][0]
        t1 = self._events[-1][0]
        total_audio = sum(a for _, a in self._events[1:])
        return total_audio / max(1e-9, t1 - t0)


class NullMetricsWriter:
    """No-op sink for non-zero processes in a multi-process run: every
    process computes the same replicated metrics, only process 0 owns
    the train-dir files (JSONL/TB append from N processes would
    interleave corruptly)."""

    path = None

    def write(self, step: int, **scalars) -> None:
        pass

    def close(self) -> None:
        pass


class MetricsWriter:
    """Metrics sink: append-only JSONL + TensorBoard event file
    (plus mirrored stdout logging).

    Two sinks: the plain JSONL (one JSON object per line with a
    monotonic step and wall-clock timestamp) and ecosystem-standard
    TensorBoard scalars (written by the zero-dependency
    utils/tb_events.py encoder, matching the reference's
    SummarySaverHook output format).
    """

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 echo: bool = True, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fh = open(self.path, "a", buffering=1)
        self.echo = echo
        self._tb = None
        if tensorboard:
            from .utils.tb_events import EventFileWriter
            self._tb = EventFileWriter(log_dir)

    def write(self, step: int, **scalars) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(step, {k: v for k, v in rec.items()
                                        if k not in ("step", "time")})
        if self.echo:
            kv = " ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k != "time")
            print(f"[metrics] {kv}", flush=True)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
