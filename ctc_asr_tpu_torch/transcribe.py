"""Transcription driver: wav file(s) -> text.

Counterpart of ``ctc_asr_tpu/transcribe.py``: one utterance at a time,
padded to a power-of-two number of seconds as the reference pads it.
"""

from __future__ import annotations

import numpy as np

from . import audio as audio_mod
from .config import Config
from .evaluate import make_decoder, make_eval_step
from .text import decode_ids


class Transcriber:
    """Holds the eval step and decoder for ``device``."""

    def __init__(self, cfg: Config, params, device="cuda"):
        self.cfg = cfg
        self.params = params
        self._eval_step = make_eval_step(cfg, device)
        self._decoder = make_decoder(cfg)
        sr = cfg.features.sample_rate
        self._pad_lengths = [int(sr * s) for s in (1, 2, 4, 8, 16, 32)]

    def _padded_length(self, n: int) -> int:
        for p in self._pad_lengths:
            if n <= p:
                return p
        return n

    def transcribe_samples(self, samples: np.ndarray) -> str:
        """Mono float32 samples at the configured rate -> transcript."""
        n = len(samples)
        S = self._padded_length(n)
        buf = np.zeros((1, S), np.float32)
        buf[0, :n] = samples[:S]
        logits, logit_lens = self._eval_step(
            self.params, buf, np.asarray([min(n, S)], np.int32))
        ids, lens = self._decoder(logits, logit_lens)
        return decode_ids(ids[0, :int(lens[0])].cpu().numpy())

    def transcribe_file(self, path: str) -> str:
        samples, _ = audio_mod.read_wav(path, self.cfg.features.sample_rate)
        return self.transcribe_samples(samples)


def check_single_process(cfg: Config) -> None:
    """Raise for any parallel regime: transcription runs in one process,
    as the reference's does (it has no multi-process path), so a config
    that names more than one process, a coordinator, or a model or
    sequence axis is refused rather than run as one process."""
    m = cfg.mesh
    if m.num_processes > 1 or m.coordinator_address or m.model_axis > 1 \
            or m.shard_model or m.seq_axis > 1:
        raise NotImplementedError(
            "transcribe runs in one process on one device, as the "
            "reference's does: drop the mesh settings (--mesh.*); data, "
            "tensor and sequence parallelism are for train and evaluate")
