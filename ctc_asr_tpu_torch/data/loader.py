"""Length-bucketed, sharded, deterministic batch loader.

The port's own copy of ``ctc_asr_tpu/data/loader.py`` (numpy batches;
the same plan, shapes and resume state as the reference's loader):

- **Static shapes**: each length bucket has a fixed [B, S_samples] /
  [B, U_label] geometry computed once from the manifest.
- **Device-side features**: batches carry padded raw samples; the
  STFT/mel frontend (features.py) runs on the device in the step.
- **Sharding**: ``(shard_idx, num_shards)`` parameterization from day one
  — each host loads a disjoint strided shard.
- **Determinism + exact resume**: every epoch's batch plan is a pure
  function of (seed, epoch); loader state is just (epoch, position) and
  round-trips through the checkpoint.
- **SortaGrad**: epoch 0 runs in duration order when enabled, matching
  the reference's length-sorted CSVs.
- **Prefetch**: a background thread pool reads wavs and assembles the
  next ``prefetch`` batches ahead of the consumer.
"""

from __future__ import annotations

import math
import os
import threading
import queue as queue_mod
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .. import audio as audio_mod
from .. import text as text_mod
from ..config import DataConfig, FeatureConfig
from .manifest import Manifest


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BucketSpec:
    max_samples: int   # static sample width S for this bucket
    max_label_len: int  # static label width U for this bucket


@dataclass(frozen=True)
class BatchSpec:
    """Static batch geometry: bucket boundaries and per-bucket pad shapes.

    Built once from the *global* (pre-shard) manifest so every host
    compiles identical shapes.
    """

    batch_size: int
    boundaries: tuple        # duration upper edge per bucket (seconds)
    buckets: tuple           # tuple[BucketSpec]
    sample_rate: int

    @staticmethod
    def from_manifest(manifest: Manifest, data_cfg: DataConfig,
                      feat_cfg: FeatureConfig) -> "BatchSpec":
        durations = np.asarray([u.duration for u in manifest])
        label_lens = np.asarray([len(u.transcript) for u in manifest])
        nb = max(1, min(data_cfg.num_buckets, len(manifest)))
        # Equal-occupancy boundaries from duration quantiles.
        qs = np.quantile(durations, np.linspace(0, 1, nb + 1)[1:])
        qs[-1] = max(qs[-1], durations.max())
        boundaries = tuple(float(q) for q in qs)
        sr = feat_cfg.sample_rate
        buckets = []
        for b in range(nb):
            lo = 0.0 if b == 0 else boundaries[b - 1]
            hi = boundaries[b]
            in_b = (durations > lo) & (durations <= hi) if b else (durations <= hi)
            # Pad widths: samples rounded to a whole hop multiple (tidy
            # frame counts); labels rounded to 8 and floored at 16.
            max_s = int(math.ceil(hi * sr))
            max_s = _round_up(max(max_s, feat_cfg.win_length),
                              feat_cfg.hop_length * 8)
            if in_b.any():
                max_u = int(label_lens[in_b].max())
            else:
                max_u = 16
            max_u = _round_up(max(max_u, 16), 8)
            buckets.append(BucketSpec(max_s, max_u))
        return BatchSpec(batch_size=data_cfg.batch_size,
                         boundaries=boundaries,
                         buckets=tuple(buckets), sample_rate=sr)

    def bucket_of(self, duration: float) -> int:
        for b, hi in enumerate(self.boundaries):
            if duration <= hi:
                return b
        return len(self.boundaries) - 1


@dataclass
class Batch:
    """One padded batch. ``samples`` are raw audio; features are computed
    on device. ``valid`` counts real (non-repeat-padded) utterances —
    only relevant for eval's final partial batch."""

    samples: np.ndarray        # [B, S] int16 wire (or f32, cfg.wire_dtype)
    sample_lengths: np.ndarray  # [B] int32
    labels: np.ndarray         # [B, U] int32 (PAD_ID padded)
    label_lengths: np.ndarray  # [B] int32
    bucket_id: int
    valid: int
    audio_seconds: float       # real (unpadded) audio in this batch
    transcripts: list = field(default_factory=list)
    paths: list = field(default_factory=list)
    # Exact-resume cursor: the loader state *after* consuming this batch
    # is {"epoch": epoch, "position": position + 1}. With prefetch the
    # loader's own cursor runs ahead, so checkpoints must use these.
    epoch: int = 0
    position: int = 0


class DataLoader:
    """Iterates padded batches over a manifest shard.

    Parameters
    ----------
    manifest: the *global* manifest (sharding happens internally so the
        BatchSpec is computed on identical data on every host).
    shard_idx / num_shards: this host's shard of the data axis.
    drop_last: True for training (static shapes, no partial batches);
        False for eval (partial batches are repeat-padded + masked).
    """

    def __init__(self, manifest: Manifest, data_cfg: DataConfig,
                 feat_cfg: FeatureConfig, shard_idx: int = 0,
                 num_shards: int = 1, drop_last: bool = True,
                 spec: BatchSpec | None = None):
        self.global_manifest = manifest.filtered(
            data_cfg.min_audio_seconds, data_cfg.max_audio_seconds,
            data_cfg.max_label_len)
        if len(self.global_manifest) == 0:
            raise ValueError("manifest is empty after length filtering")
        self.spec = spec or BatchSpec.from_manifest(
            self.global_manifest, data_cfg, feat_cfg)
        self.shard = self.global_manifest.shard(shard_idx, num_shards)
        self.cfg = data_cfg
        self.feat_cfg = feat_cfg
        self.drop_last = drop_last
        if data_cfg.wire_dtype not in ("int16", "ulaw", "float32"):
            raise ValueError(
                f"unknown wire_dtype {data_cfg.wire_dtype!r} "
                "(expected 'int16', 'ulaw' or 'float32')")
        self.cache = None
        if data_cfg.feature_cache:
            from .feature_cache import FeatureCache
            self.cache = FeatureCache(data_cfg.feature_cache, feat_cfg)
        self.epoch = 0
        self.position = 0  # next batch index within the current epoch plan
        self.consumed: tuple | None = None  # (epoch, pos) last yielded
        self._iter_base: tuple | None = None  # cursor at iterator start
        self._plan_cache: tuple | None = None  # (epoch, plan)
        # num_workers == 0: auto-size to the host (see DataConfig);
        # 2x cores wins by overlapping file I/O with decode
        self._n_workers = data_cfg.num_workers or min(
            2 * (os.cpu_count() or 2), 16)
        self._pool = ThreadPoolExecutor(max_workers=self._n_workers)

    # -- deterministic epoch planning ------------------------------------

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.shard)
        if epoch == 0 and self.cfg.sortagrad:
            durs = np.asarray([u.duration for u in self.shard])
            return np.argsort(durs, kind="stable")
        rng = np.random.default_rng((self.cfg.seed, epoch))
        return rng.permutation(n)

    def epoch_plan(self, epoch: int) -> list:
        """List of (bucket_id, utterance-index tuple, valid_count)."""
        if self._plan_cache and self._plan_cache[0] == epoch:
            return self._plan_cache[1]
        order = self._epoch_order(epoch)
        pending: dict[int, list] = {}
        plan = []
        for idx in order:
            b = self.spec.bucket_of(self.shard[int(idx)].duration)
            pending.setdefault(b, []).append(int(idx))
            if len(pending[b]) == self.spec.batch_size:
                plan.append((b, tuple(pending[b]), self.spec.batch_size))
                pending[b] = []
        if not self.drop_last:
            for b, idxs in sorted(pending.items()):
                if not idxs:
                    continue
                valid = len(idxs)
                idxs = idxs + [idxs[-1]] * (self.spec.batch_size - valid)
                plan.append((b, tuple(idxs), valid))
        self._plan_cache = (epoch, plan)
        return plan

    def batches_per_epoch(self) -> int:
        return len(self.epoch_plan(self.epoch))

    # -- materialization --------------------------------------------------

    def _decode_batch(self, paths: list, max_samples: int):
        """Batch of wav paths -> (padded [B, S] float32, lengths [B]).

        Fast path: one call into the native C++ decoder
        (data/native_io.py), which reads/decodes/pads the whole batch in
        worker threads. Files the native path can't handle (decode
        failure or a sample rate needing resample) fall back to the
        scipy path individually.
        """
        B = len(paths)
        samples = rates = None
        try:
            from . import native_io
            if native_io.available():
                samples, slens, rates = native_io.decode_batch(
                    paths, max_samples, n_threads=self._n_workers)
                redo = [i for i in range(B)
                        if slens[i] == 0 or rates[i] != self.spec.sample_rate]
            else:
                redo = list(range(B))
        except Exception:
            redo = list(range(B))
        if samples is None:
            samples = np.zeros((B, max_samples), np.float32)
            slens = np.zeros((B,), np.int32)
        if redo:
            target_sr = self.spec.sample_rate

            def load_one(i):
                # rate-mismatched file the native path DID decode:
                # re-decode natively with a rate-scaled cap (the batch
                # call truncated at the TARGET-rate width) and resample
                # on host — re-reading via the scipy fallback would
                # break for FLAC, which it can't parse (ADVICE r3)
                if rates is not None and slens[i] > 0 \
                        and rates[i] not in (0, target_sr):
                    from . import native_io
                    cap = -(-max_samples * int(rates[i])) // target_sr + 64
                    full, fl, fr = native_io.decode_batch(
                        [paths[i]], cap, n_threads=1)
                    if fl[0] > 0:
                        s = audio_mod.resample(
                            np.array(full[0, :fl[0]], np.float32),
                            int(fr[0]), target_sr)
                        return i, s
                # native decode failed outright: scipy handles wav;
                # FLAC has no fallback decoder, so fail loudly instead
                # of a confusing wav-parse error
                with open(paths[i], "rb") as f:
                    magic = f.read(4)
                if magic == b"fLaC":
                    raise RuntimeError(
                        f"native FLAC decode failed for {paths[i]!r} "
                        "and no fallback decoder exists for .flac "
                        "(corrupt file, or the native library is "
                        "unavailable — build native/ctcasr_io.cc)")
                s, _ = audio_mod.read_wav(paths[i], target_sr)
                return i, s
            for i, s in self._pool.map(load_one, redo):
                n = min(len(s), max_samples)
                samples[i, :] = 0.0
                samples[i, :n] = s[:n]
                slens[i] = n
        return samples, slens

    def bucket_frames(self, bucket_id: int) -> int:
        """Static feature-frame width for a bucket (cache mode)."""
        from .. import features as feat_mod
        return max(1, feat_mod.num_frames(
            self.spec.buckets[bucket_id].max_samples, self.feat_cfg))

    def materialize(self, bucket_id: int, idxs, valid: int) -> Batch:
        bspec = self.spec.buckets[bucket_id]
        B = len(idxs)
        utts = [self.shard[i] for i in idxs]
        transcripts = [u.transcript for u in utts]
        paths = [u.path for u in utts]
        if self.cache is not None:
            # precomputed-feature mode: samples carries [B, T, F] float16
            # features, sample_lengths carries frame counts (the step's
            # extract_features passes 3-D inputs through).
            feats, flens = self.cache.read_batch(
                paths, self.bucket_frames(bucket_id))
            labels, llens = text_mod.encode_batch(
                transcripts, max_len=bspec.max_label_len)
            audio_secs = float(sum(u.duration for u in utts[:valid]))
            return Batch(samples=feats, sample_lengths=flens,
                         labels=labels, label_lengths=llens,
                         bucket_id=bucket_id, valid=valid,
                         audio_seconds=audio_secs, transcripts=transcripts,
                         paths=paths)
        samples, slens = self._decode_batch(paths, bspec.max_samples)
        if self.cfg.wire_dtype == "int16":
            # halve host->device bytes; exact for int16-PCM sources
            # (the device side rescales — features.extract_features)
            samples = audio_mod.float_to_wire16(samples)
        elif self.cfg.wire_dtype == "ulaw":
            # quarter the bytes: uint8 companded (G.711-style);
            # device-side inverse in features.extract_features
            samples = audio_mod.float_to_ulaw(samples)
        labels, llens = text_mod.encode_batch(transcripts,
                                              max_len=bspec.max_label_len)
        audio_secs = float(slens[:valid].sum()) / self.spec.sample_rate
        return Batch(samples=samples, sample_lengths=slens, labels=labels,
                     label_lengths=llens, bucket_id=bucket_id, valid=valid,
                     audio_seconds=audio_secs, transcripts=transcripts,
                     paths=paths)

    # -- iteration + resume ----------------------------------------------

    def state_dict(self) -> dict:
        """Cursor of the NEXT batch to train on. With prefetch active
        the internal position runs ahead of what the consumer has seen;
        ``consumed`` (set per yielded batch by the prefetch iterator,
        and re-pinned per *trained* batch by train.device_batches) is
        the honest resume point. Before anything is consumed, the
        cursor captured at iterator start is used — the producer may
        already have advanced the internal position by prefetch+1."""
        if self.consumed is not None:
            ep, pos = self.consumed
            return {"epoch": ep, "position": pos + 1, "seed": self.cfg.seed}
        if self._iter_base is not None:
            ep, pos = self._iter_base
            return {"epoch": ep, "position": pos, "seed": self.cfg.seed}
        return {"epoch": self.epoch, "position": self.position,
                "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        saved_seed = state.get("seed", self.cfg.seed)
        if saved_seed != self.cfg.seed:
            raise ValueError(
                f"checkpoint data seed {saved_seed} != cfg.data.seed "
                f"{self.cfg.seed}: the saved cursor indexes a different "
                "batch plan (fix the config or start a fresh run)")
        self.epoch = int(state["epoch"])
        self.position = int(state["position"])
        # stale pre-restore cursors must not shadow the restored state
        self.consumed = None
        self._iter_base = None

    def __iter__(self):
        """Endless batch stream (training). Epochs advance automatically;
        a background queue keeps ``prefetch`` batches in flight."""
        return _PrefetchIterator(self, self.cfg.prefetch)

    def _next_assignment(self):
        plan = self.epoch_plan(self.epoch)
        while self.position >= len(plan):
            self.epoch += 1
            self.position = 0
            plan = self.epoch_plan(self.epoch)
        item = plan[self.position]
        cursor = (self.epoch, self.position)
        self.position += 1
        return item, cursor

    def iter_epoch(self, epoch: int | None = None):
        """One pass over the shard (evaluation); no prefetch, no mutation
        of training state."""
        e = self.epoch if epoch is None else epoch
        for b, idxs, valid in self.epoch_plan(e):
            yield self.materialize(b, idxs, valid)


class _PrefetchIterator:
    def __init__(self, loader: DataLoader, depth: int):
        self.loader = loader
        # capture the resume cursor BEFORE the producer advances the
        # internal position by up to depth+1 (state_dict falls back to
        # this until the first batch is consumed)
        if loader._iter_base is None and loader.consumed is None:
            loader._iter_base = (loader.epoch, loader.position)
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._dead: BaseException | None = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        try:
            while not self._stop.is_set():
                (b, idxs, valid), (ep, pos) = \
                    self.loader._next_assignment()
                batch = self.loader.materialize(b, idxs, valid)
                batch.epoch, batch.position = ep, pos
                while not self._stop.is_set():
                    try:
                        self.queue.put(batch, timeout=0.5)
                        break
                    except queue_mod.Full:
                        continue
        except BaseException as e:  # surface in the consumer, don't hang
            self._put_forever(e)

    def _put_forever(self, item):
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.5)
                return
            except queue_mod.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        if self._dead is not None:
            # the producer already died; fail fast on EVERY call instead
            # of blocking on the dead producer's empty queue
            raise RuntimeError("data loader producer failed") from self._dead
        item = self.queue.get()
        if isinstance(item, BaseException):
            # producer died (e.g. unreadable wav): re-raise HERE instead
            # of blocking forever on an empty queue
            self._dead = item
            raise RuntimeError("data loader producer failed") from item
        # the loader's own cursor runs prefetch batches ahead; track
        # what was actually CONSUMED so state_dict() resumes exactly
        self.loader.consumed = (item.epoch, item.position)
        return item

    def close(self):
        self._stop.set()
