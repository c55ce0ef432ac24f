"""CSV manifests: (wav path, duration, transcript) per utterance.

The port's own copy of ``ctc_asr_tpu/data/manifest.py``. Format: ``path;duration_seconds;transcript`` — semicolon-separated
because transcripts contain no semicolons after normalization.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .. import audio as audio_mod
from .. import text as text_mod


@dataclass(frozen=True)
class Utterance:
    path: str
    duration: float  # seconds of audio
    transcript: str  # normalized (lowercase a-z, space, apostrophe)


@dataclass
class Manifest:
    utterances: list

    def __len__(self):
        return len(self.utterances)

    def __iter__(self):
        return iter(self.utterances)

    def __getitem__(self, i):
        return self.utterances[i]

    @property
    def total_audio_seconds(self) -> float:
        return sum(u.duration for u in self.utterances)

    def sorted_by_duration(self) -> "Manifest":
        """SortaGrad order (the reference sorted its CSVs by audio length)."""
        return Manifest(sorted(self.utterances, key=lambda u: u.duration))

    def filtered(self, min_seconds: float, max_seconds: float,
                 max_label_len: int) -> "Manifest":
        """Drop too-short/too-long utterances (as the reference did at
        dataset-generation time)."""
        keep = [u for u in self.utterances
                if min_seconds <= u.duration <= max_seconds
                and 0 < len(u.transcript) <= max_label_len]
        return Manifest(keep)

    def shard(self, shard_idx: int, num_shards: int) -> "Manifest":
        """Deterministic per-host shard: every num_shards-th utterance.

        Strided (not contiguous) so each shard sees the full duration
        distribution — keeps per-host bucket occupancy balanced.
        """
        if not (0 <= shard_idx < num_shards):
            raise ValueError(f"bad shard {shard_idx}/{num_shards}")
        return Manifest(self.utterances[shard_idx::num_shards])


def write_manifest(path: str, manifest: Manifest) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for u in manifest:
            f.write(f"{u.path};{u.duration:.3f};{u.transcript}\n")


def read_manifest(path: str) -> Manifest:
    utts = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            p, dur, transcript = line.split(";", 2)
            utts.append(Utterance(p, float(dur), transcript))
    return Manifest(utts)


def build_manifest_from_dir(wav_dir: str, transcripts: dict) -> Manifest:
    """Build a manifest from a directory of wavs + {utt_id: transcript}.

    ``utt_id`` is the wav filename without extension. Durations come from
    the wav headers (no decode). Used by the corpus generators
    (``generate.py``) and tests.
    """
    utts = []
    for utt_id, transcript in sorted(transcripts.items()):
        wav_path = os.path.join(wav_dir, utt_id + ".wav")
        if not os.path.exists(wav_path):
            continue
        dur = audio_mod.duration_seconds(wav_path)
        utts.append(Utterance(wav_path, dur,
                              text_mod.normalize_transcript(transcript)))
    return Manifest(utts)
