"""The one generator of traffic: a mix's file of parameters
(``traffic/<name>.json``) and a seed -> an endless stream of padded
batches, in the wire format the port's loader hands to the device.

What a seed changes and what it leaves alone:

- The lengths are fixed by the mix: ``pool_batches_per_bucket`` x
  ``num_buckets`` x ``batch_size`` durations at stratified quantiles of
  the mix's distribution (``duration_quantiles``, a piecewise-linear
  inverse CDF), truncated to the preset's filter ``filter_seconds`` as
  the loader drops what lies outside it.
- Buckets follow a frozen copy of the loader's rule
  (``ctc_asr_tpu_torch/data/loader.py`` ``BatchSpec.from_manifest``):
  equal occupancy by duration rank, samples padded to the bucket's upper
  edge (its ``np.quantile`` boundary) rounded up to 8 hops, labels to the
  bucket's longest rounded up to 8 and at least 16.
- A cycle runs every bucket once, alternating the shortest and the
  longest left (0, 7, 1, 6, ...), so that a run's first steps hold both
  the longest rows and the widest spread of lengths. A seed draws, for
  each pass over the pool, which length goes to which row of which
  batch, and for each batch fresh audio (seeded noise at ``noise_rms``, int16) and text
  (seeded words over a seeded vocabulary, ``chars_per_second``
  characters a second). So two seeds give the same shapes and the same
  audio seconds in every whole pass, and different contents.

Batch ``j`` of a stream is a pure function of (mix, seed, j): a judge
rebuilds any batch after the window from its index.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TRAFFIC_DIR = os.path.join(HERE, "traffic")

# the port's label alphabet (``ctc_asr_tpu_torch/text.py``): ids 0..27,
# blank 28, which also pads labels
ALPHABET = " abcdefghijklmnopqrstuvwxyz'"
PAD_ID = len(ALPHABET)
_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
BANK_SECONDS = 300          # seeded noise every batch's rows are cut from
TEXT_BANK_CHARS = 1 << 20   # seeded text every row's transcript is cut from


def load_mix(name: str, directory: str = TRAFFIC_DIR) -> dict:
    path = os.path.join(directory, f"{name}.json")
    with open(path) as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one purpose of one run, from the run's seed."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def pool_durations(mix: dict) -> np.ndarray:
    """The mix's fixed set of durations (s), ascending."""
    nb, B = mix["num_buckets"], mix["batch_size"]
    n = nb * B * mix["pool_batches_per_bucket"]
    q = np.asarray([p for p, _ in mix["duration_quantiles"]], np.float64)
    s = np.asarray([v for _, v in mix["duration_quantiles"]], np.float64)
    lo, hi = mix["filter_seconds"]
    u_lo, u_hi = np.interp([lo, hi], s, q)
    u = u_lo + (np.arange(n) + 0.5) / n * (u_hi - u_lo)
    return np.sort(np.interp(u, q, s))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Bucket:
    durations: np.ndarray      # this bucket's pool durations (s)
    n_samples: np.ndarray      # the same as whole samples
    label_lens: np.ndarray     # characters of each
    max_samples: int           # padded sample width
    max_label_len: int         # padded label width


@dataclass
class Plan:
    mix: dict
    buckets: list = field(default_factory=list)
    order: list = field(default_factory=list)   # bucket ids of one cycle

    @property
    def batch_size(self) -> int:
        return self.mix["batch_size"]

    @property
    def cycle(self) -> int:
        return len(self.order)


def plan(mix: dict, win_length: int = 400, hop_length: int = 160) -> Plan:
    """Buckets, widths and the cycle order of a mix (no seed)."""
    durs = pool_durations(mix)
    sr, nb, B = mix["sample_rate"], mix["num_buckets"], mix["batch_size"]
    qs = np.quantile(durs, np.linspace(0, 1, nb + 1)[1:])
    qs[-1] = max(qs[-1], durs.max())
    per = len(durs) // nb
    out = Plan(mix)
    for b in range(nb):
        d = durs[b * per:(b + 1) * per]
        n = np.rint(d * sr).astype(np.int64)
        labels = np.maximum(1, np.rint(d * mix["chars_per_second"])
                            ).astype(np.int64)
        hi = max(float(qs[b]), float(d.max()))
        max_s = _round_up(max(int(math.ceil(hi * sr)), win_length),
                          hop_length * 8)
        max_u = _round_up(max(int(labels.max()), 16), 8)
        out.buckets.append(Bucket(d, n, labels, max_s, max_u))
    out.order = [i // 2 if i % 2 == 0 else nb - 1 - i // 2
                 for i in range(nb)]
    return out


@dataclass
class HostBatch:
    """One padded batch as the port's loader makes it (``data.Batch``'s
    fields that its device feed reads)."""

    index: int
    bucket_id: int
    samples: np.ndarray         # [B, S] int16 (rows are views of one bank)
    sample_lengths: np.ndarray  # [B] int32
    labels: np.ndarray          # [B, U] int32, PAD_ID padded
    label_lengths: np.ndarray   # [B] int32
    audio_seconds: float
    valid: int


class Stream:
    """Batches of a mix from a seed: ``batch(j)`` for any j >= 0. The
    noise and text banks are made once."""

    def __init__(self, plan_: Plan, seed: int):
        self.plan, self.seed = plan_, int(seed)
        mix = plan_.mix
        rng = np.random.default_rng(sub_seed(seed, 1))
        n = BANK_SECONDS * mix["sample_rate"]
        self.bank = np.clip(np.rint(rng.standard_normal(n) * mix["noise_rms"]
                                    * 32768.0), -32768, 32767
                            ).astype(np.int16)
        self.text = make_text_bank(mix, seed)
        self.text_ids = _char_ids(np.frombuffer(self.text.encode(), np.uint8))

    def lengths(self, j: int) -> tuple[int, np.ndarray]:
        """(bucket, pool index of each row) of batch j: the bucket's pool
        permuted anew for each pass over the pool, then cut in rows."""
        p = self.plan
        cyc, pos = divmod(j, p.cycle)
        b = p.order[pos]
        P = p.mix["pool_batches_per_bucket"]
        rnd, slot = divmod(cyc, P)
        perm = np.random.default_rng(sub_seed(self.seed, 2, b, rnd)
                                     ).permutation(len(p.buckets[b].durations))
        B = p.batch_size
        return b, perm[slot * B:(slot + 1) * B]

    def batch(self, j: int) -> HostBatch:
        b, rows = self.lengths(j)
        bk = self.plan.buckets[b]
        B, S, U = len(rows), bk.max_samples, bk.max_label_len
        lens = bk.n_samples[rows].astype(np.int32)
        rng = np.random.default_rng(sub_seed(self.seed, 3, j))
        # row i is the bank from o + i * d on: one strided view (the feed's
        # worker copies it, as the port's loader assembles its batches)
        d = int(rng.integers(1, (len(self.bank) - S) // B))
        o = int(rng.integers(0, len(self.bank) - S - (B - 1) * d))
        view = np.lib.stride_tricks.as_strided(
            self.bank[o:], shape=(B, S), strides=(d * 2, 2), writeable=False)
        llens = bk.label_lens[rows].astype(np.int32)
        labels = np.full((B, U), PAD_ID, np.int32)
        starts = rng.integers(0, len(self.text_ids) - U, B)
        for i, (s0, n) in enumerate(zip(starts, llens)):
            labels[i, :n] = self.text_ids[s0:s0 + n]
        return HostBatch(j, b, view, lens, labels, llens,
                         float(lens.sum()) / self.plan.mix["sample_rate"], B)

    def calibration(self, rows: int, seconds: float) -> np.ndarray:
        """[rows, seconds] int16 cut from the bank at seeded offsets, apart
        from every batch of the stream's draws."""
        n = int(seconds * self.plan.mix["sample_rate"])
        rng = np.random.default_rng(sub_seed(self.seed, 5))
        offs = rng.integers(0, len(self.bank) - n, rows)
        return np.stack([self.bank[o:o + n] for o in offs])


def _char_ids(ascii_codes: np.ndarray) -> np.ndarray:
    table = np.full(256, PAD_ID, np.int32)
    for i, c in enumerate(ALPHABET):
        table[ord(c)] = i
    return table[ascii_codes]


def make_text_bank(mix: dict, seed: int) -> str:
    """Seeded words over a seeded vocabulary, joined by spaces, about
    ``TEXT_BANK_CHARS`` long. Word frequencies follow a Zipf law (rank r
    drawn with weight 1/r), as a text's do."""
    rng = np.random.default_rng(sub_seed(seed, 4))
    lo, hi = mix["word_letters"]
    nv = mix["vocabulary_words"]
    lens = rng.integers(lo, hi + 1, nv)
    letters = _LETTERS[rng.integers(0, 26, int(lens.sum()))].tobytes()
    cuts = np.concatenate([[0], np.cumsum(lens)])
    vocab = [letters[a:b].decode() for a, b in zip(cuts[:-1], cuts[1:])]
    w = 1.0 / np.arange(1, nv + 1)
    n_words = TEXT_BANK_CHARS // int(lens.mean() + 1)
    picks = rng.choice(nv, n_words, p=w / w.sum())
    return " ".join(vocab[i] for i in picks)


def lm_corpus(stream: Stream, n_lines: int = 4096,
              line_chars: int = 120) -> list[str]:
    """Lines of the stream's text bank, whole words, for the n-gram LMs."""
    words = stream.text.split(" ")
    out, cur, n = [], [], 0
    for w in words:
        cur.append(w)
        n += len(w) + 1
        if n >= line_chars:
            out.append(" ".join(cur))
            cur, n = [], 0
            if len(out) == n_lines:
                break
    return out
