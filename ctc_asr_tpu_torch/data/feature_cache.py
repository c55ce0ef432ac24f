"""Precomputed-feature cache: features-to-disk mode for the input pipeline.

Counterpart of ``ctc_asr_tpu/data/feature_cache.py``: the constants,
``feature_key``, the writer (``prepare-features``) and the reader. With
``data.feature_cache=DIR`` the loader ships [B, T, F] float16 (or int8)
features instead of raw samples, and the step does no DSP. The files
are the reference's: a cache written by either package is read by the
other.

Storage layout (``<dir>/``):
  features.bin   raw little-endian float16, all utterances concatenated
                 row-major as [n_frames, feat_dim]
  index.json     {"dim", "dtype", "feature_key", "entries":
                  {utt_path: [frame_offset, n_frames]}}

Features are stored POST-normalization (the cache is only valid for
feature configs whose normalization is per-utterance, "none", or
"global" with a stats file — anything batch-dependent cannot be baked
per utterance). ``feature_key`` fingerprints the FeatureConfig so a
stale cache is rejected at load instead of silently training on wrong
features.

Reads go through one shared ``np.memmap`` — zero-copy page-cache I/O,
no per-utterance file opens.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from ..config import DataConfig, FeatureConfig

# Fixed dequantization scale for the int8 cache wire: cached features
# are POST-normalization (~zero-mean unit-variance), so a fixed scale
# of 16 covers +-7.9 sigma at 1/16 resolution (quantization noise
# sigma ~ 0.018 against unit-variance features). A fixed scale keeps
# the wire a bare int8 tensor - no per-utterance side channel through
# the loader/step signatures. Shared by build (quantize) and
# features.extract_features (device dequant).
FEATURE_INT8_SCALE = 16.0


def feature_key(cfg: FeatureConfig) -> str:
    """Stable fingerprint of every field that changes feature values.

    When ``stats_path`` is set, the fingerprint includes a hash of the
    stats file CONTENTS, not just the path — regenerating stats at the
    same path must invalidate the cache rather than be silently accepted.
    """
    d = dataclasses.asdict(cfg)
    d.pop("use_pallas", None)  # dispatch choice, parity-tested identical
    if cfg.stats_path and os.path.exists(cfg.stats_path):
        with open(cfg.stats_path, "rb") as f:
            d["stats_sha1"] = hashlib.sha1(f.read()).hexdigest()
    return json.dumps(d, sort_keys=True)


def _check_cacheable(cfg: FeatureConfig) -> None:
    if cfg.normalization == "global" and not cfg.stats_path:
        raise ValueError(
            "feature cache with normalization='global' requires "
            "features.stats_path (run the compute-stats CLI first): the "
            "whole-batch fallback is batch-dependent and cannot be baked "
            "per utterance")


def build_feature_cache(manifest, data_cfg: DataConfig,
                        feat_cfg: FeatureConfig, out_dir: str,
                        progress_every: int = 50, dtype: str = "float16",
                        device="cuda") -> str:
    """Extract features for every manifest utterance and write the cache.

    Runs the normal frontend on ``device`` (the fused STFT kernel when
    ``features.use_pallas``) over loader-bucketed batches, fetches the
    valid rows/frames, and appends them to ``features.bin``. Returns
    ``out_dir``.

    ``dtype``: "float16" (default) or "int8" — the int8 wire halves
    upload bytes again at fixed-scale quantization (FEATURE_INT8_SCALE).
    """
    if dtype not in ("float16", "int8"):
        raise ValueError(f"unsupported cache dtype {dtype!r}")
    import torch

    from .. import features as feat_mod
    from ..ops.dispatch import resolve_device
    from .loader import DataLoader

    _check_cacheable(feat_cfg)
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    # Cache the WHOLE manifest: neutralize the length/label filters so a
    # train-time config with wider bounds than the prepare-features
    # invocation cannot hit "utterance not in cache" (bucket shapes are
    # quantile-derived from actual durations, not from these bounds, so
    # widening them only adds utterances).
    data_cfg = dataclasses.replace(
        data_cfg, min_audio_seconds=0.0, max_audio_seconds=float("inf"),
        max_label_len=10 ** 9)
    loader = DataLoader(manifest, data_cfg, feat_cfg, drop_last=False)
    entries: dict[str, list] = {}
    offset = 0
    dim = feat_cfg.feature_dim
    n_done = 0
    bin_path = os.path.join(out_dir, "features.bin")
    with open(bin_path, "wb") as f:
        for batch in loader.iter_epoch(0):
            feats, flens = feat_mod.extract_features(
                torch.from_numpy(batch.samples).to(dev),
                torch.from_numpy(batch.sample_lengths).to(dev), feat_cfg)
            feats = feats.cpu().numpy()
            if dtype == "int8":
                feats = np.clip(np.rint(feats * FEATURE_INT8_SCALE),
                                -127, 127).astype(np.int8)
            else:
                feats = feats.astype(np.float16)
            flens = flens.cpu().numpy()
            for i in range(batch.valid):
                path = batch.paths[i]
                if path in entries:  # repeat-padded rows point at utt[-1]
                    continue
                n = int(flens[i])
                f.write(np.ascontiguousarray(feats[i, :n]).tobytes())
                entries[path] = [offset, n]
                offset += n
                n_done += 1
                if progress_every and n_done % progress_every == 0:
                    print(f"[feature-cache] {n_done}/{len(manifest)} "
                          "utterances", flush=True)
    index = {"dim": dim, "dtype": dtype,
             "feature_key": feature_key(feat_cfg), "entries": entries}
    if dtype == "int8":
        index["int8_scale"] = FEATURE_INT8_SCALE
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f)
    isize = 1 if dtype == "int8" else 2
    print(f"[feature-cache] wrote {n_done} utterances "
          f"({offset} frames, {offset * dim * isize / 1e6:.1f} MB, "
          f"{dtype}) to {out_dir}", flush=True)
    return out_dir


class FeatureCache:
    """Memory-mapped reader for a cache built by build_feature_cache."""

    def __init__(self, cache_dir: str, feat_cfg: FeatureConfig | None = None):
        with open(os.path.join(cache_dir, "index.json")) as f:
            index = json.load(f)
        if feat_cfg is not None:
            want = feature_key(feat_cfg)
            if index["feature_key"] != want:
                raise ValueError(
                    f"feature cache at {cache_dir} was built with a "
                    "different FeatureConfig — rebuild it (prepare-features "
                    f"CLI).\n  cache: {index['feature_key']}\n"
                    f"  config: {want}")
        self.dim = int(index["dim"])
        self.dtype = index.get("dtype", "float16")
        self.np_dtype = {"float16": np.float16,
                         "int8": np.int8}[self.dtype]
        if self.dtype == "int8" and \
                index.get("int8_scale") != FEATURE_INT8_SCALE:
            raise ValueError(
                f"int8 cache at {cache_dir} was built with scale "
                f"{index.get('int8_scale')}, this build expects "
                f"{FEATURE_INT8_SCALE} — rebuild the cache")
        self.entries = index["entries"]
        self._data = np.memmap(os.path.join(cache_dir, "features.bin"),
                               dtype=self.np_dtype, mode="r").reshape(
                                   -1, self.dim)

    def __contains__(self, path: str) -> bool:
        return path in self.entries

    def read(self, path: str) -> np.ndarray:
        """[n_frames, dim] cache-dtype view (zero-copy), one utterance."""
        try:
            off, n = self.entries[path]
        except KeyError:
            raise ValueError(
                f"utterance {path!r} is not in the feature cache (the "
                "manifest was extended after prepare-features ran?) — "
                "rebuild the cache with the prepare-features CLI") from None
        return self._data[off:off + n]

    def read_batch(self, paths: list, max_frames: int):
        """Padded [B, max_frames, dim] cache-dtype + frame lengths [B]."""
        B = len(paths)
        out = np.zeros((B, max_frames, self.dim), self.np_dtype)
        lens = np.zeros((B,), np.int32)
        for i, p in enumerate(paths):
            x = self.read(p)
            n = min(len(x), max_frames)
            out[i, :n] = x[:n]
            lens[i] = n
        return out, lens
