"""Feature extraction: framing -> window -> real DFT -> mel -> log (-> DCT).

Counterpart of ``ctc_asr_tpu/features.py``. The constant builders are
the reference's numpy code carried over (the reference module imports
JAX, so it cannot be imported here); the plain path is the same
matmul formulation in PyTorch: [B, S] padded samples -> [B, T, F].

``extract_features`` is the serving path's single entry point. With
``cfg.use_pallas`` (the reference's switch for its fused kernel) it
calls the fused STFT kernel wrapper ``ops.stft_cuda.stft_features``,
which launches the CUDA kernel for a CUDA tensor and computes the plain
version below for a CPU tensor; with ``use_pallas=False`` it computes
the plain version directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .audio import ULAW_MU, WIRE_SCALE
from .config import FeatureConfig
from .utils.profiling import span

# the profiler range around ``extract_features``
FEATURES_RANGE = "features.extract"


# ---------------------------------------------------------------------------
# Precomputed constant matrices (host-side numpy, cached per-geometry)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def dft_matrices(win_length: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT as matmul: returns (cos, -sin) matrices [win, n_fft//2+1].

    power_spectrum(frame) == (frame @ cos)**2 + (frame @ msin)**2 for a
    frame zero-padded to n_fft (the zero-padding is folded in by
    truncating the DFT basis rows to win_length).
    """
    n_bins = n_fft // 2 + 1
    n = np.arange(win_length)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / float(n_fft)
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_fft: int, n_mels: int, sample_rate: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank matrix [n_fft//2+1, n_mels] (HTK scale)."""
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_freqs = np.arange(n_bins) * sample_rate / float(n_fft)
    fb = np.zeros((n_bins, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - bin_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache(maxsize=8)
def dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_mels, n_mfcc]."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    mat = np.cos(np.pi * (2.0 * n + 1.0) * k / (2.0 * n_mels))
    mat *= np.sqrt(2.0 / n_mels)
    mat[:, 0] *= np.sqrt(0.5) if n_mfcc > 0 else 1.0
    return mat.astype(np.float32)


# ---------------------------------------------------------------------------
# Shape helpers
# ---------------------------------------------------------------------------

def num_frames(n_samples: int, cfg: FeatureConfig) -> int:
    """Frame count for ``n_samples`` samples (no centering/padding)."""
    if n_samples < cfg.win_length:
        return 0
    return 1 + (n_samples - cfg.win_length) // cfg.hop_length


def frame_lengths_from_sample_lengths(sample_lengths, cfg: FeatureConfig):
    """Vector version of num_frames (torch or numpy), clipped at >= 0."""
    if isinstance(sample_lengths, torch.Tensor):
        n = 1 + torch.div(sample_lengths.long() - cfg.win_length,
                          cfg.hop_length, rounding_mode="floor")
        return n.clamp_min(0).to(torch.int32)
    return np.maximum(
        0, 1 + (np.asarray(sample_lengths) - cfg.win_length)
        // cfg.hop_length).astype(np.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch feature pipeline (the reference for the fused STFT kernel)
# ---------------------------------------------------------------------------

def frame_signal(samples: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """[..., S] samples -> [..., T, win] frames via a static gather.

    Indices clamp at S-1, so an input shorter than one window still
    yields one frame (the edge sample repeated), as in the reference."""
    S = samples.shape[-1]
    T = max(1, num_frames(S, cfg))
    idx = (np.arange(T)[:, None] * cfg.hop_length
           + np.arange(cfg.win_length)[None, :])
    idx = np.minimum(idx, S - 1)
    return samples[..., torch.as_tensor(idx, device=samples.device)]


def log_mel_spectrogram(samples: torch.Tensor, cfg: FeatureConfig,
                        log_floor: float = 1e-6) -> torch.Tensor:
    """[..., S] float32 samples -> [..., T, n_mels] log-mel features."""
    dev = samples.device
    frames = frame_signal(samples, cfg) * torch.as_tensor(
        hann_window(cfg.win_length), device=dev)
    cos_m, msin_m = dft_matrices(cfg.win_length, cfg.n_fft)
    re = frames @ torch.as_tensor(cos_m, device=dev)
    im = frames @ torch.as_tensor(msin_m, device=dev)
    power = re * re + im * im
    fb = torch.as_tensor(mel_filterbank(cfg.n_fft, cfg.n_mels,
                                        cfg.sample_rate, cfg.fmin, cfg.fmax),
                         device=dev)
    return torch.log(torch.clamp_min(power @ fb, log_floor))


def mfcc(samples: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """[..., S] samples -> [..., T, n_mfcc] MFCCs (DCT-II of log-mel)."""
    return log_mel_spectrogram(samples, cfg) @ torch.as_tensor(
        dct_matrix(cfg.n_mels, cfg.n_mfcc), device=samples.device)


def plain_features(samples: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Un-normalized [B, T, F] features of ``cfg.feature_type``."""
    if cfg.feature_type == "mfcc":
        return mfcc(samples, cfg)
    if cfg.feature_type == "mel":
        return log_mel_spectrogram(samples, cfg)
    raise ValueError(f"unknown feature_type {cfg.feature_type!r}")


def normalize_features(feats: torch.Tensor, frame_lengths: torch.Tensor,
                       mode: str = "utterance", stats=None) -> torch.Tensor:
    """Per-utterance (masked) or dataset-level mean/variance
    normalization; padding frames are excluded from the statistics and
    zeroed on output. ``stats``: optional (mean [F], var [F]) for
    "global" mode; without them "global" uses whole-batch statistics."""
    B, T, F = feats.shape
    mask = (torch.arange(T, device=feats.device)[None, :]
            < frame_lengths[:, None])
    maskf = mask[..., None].to(feats.dtype)
    n = torch.clamp_min(frame_lengths.to(feats.dtype), 1.0)[:, None, None]
    if mode == "none":
        out = feats
    elif mode == "utterance":
        mean = torch.sum(feats * maskf, dim=1, keepdim=True) / n
        var = torch.sum(torch.square(feats - mean) * maskf, dim=1,
                        keepdim=True) / n
        out = (feats - mean) * torch.rsqrt(var + 1e-8)
    elif mode == "global":
        if stats is not None:
            mean = torch.as_tensor(stats[0], device=feats.device
                                   ).reshape(1, 1, -1)
            var = torch.as_tensor(stats[1], device=feats.device
                                  ).reshape(1, 1, -1)
        else:
            total = torch.sum(maskf)
            mean = torch.sum(feats * maskf, dim=(0, 1), keepdim=True) / total
            var = torch.sum(torch.square(feats - mean) * maskf, dim=(0, 1),
                            keepdim=True) / total
        out = (feats - mean) * torch.rsqrt(var + 1e-8)
    else:
        raise ValueError(f"unknown normalization mode {mode!r}")
    return out * maskf


def decode_wire(samples: torch.Tensor) -> torch.Tensor:
    """Raw samples as f32: int16 wire samples scaled by 1/WIRE_SCALE,
    uint8 mu-law expanded, anything else cast."""
    if samples.dtype == torch.int16:
        return samples.to(torch.float32) * (1.0 / WIRE_SCALE)
    if samples.dtype == torch.uint8:
        y = samples.to(torch.float32) * (1.0 / 127.5) - 1.0
        return torch.sign(y) * (
            torch.exp(torch.abs(y) * float(np.log1p(ULAW_MU))) - 1.0) / ULAW_MU
    return samples.to(torch.float32)


def extract_features(samples: torch.Tensor, sample_lengths: torch.Tensor,
                     cfg: FeatureConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched frontend: [B, S], [B] -> ([B, T, F] f32, [B] int32).

    Accepts int16 or uint8 mu-law wire samples (decoded on the device)
    and 3-D precomputed-feature batches from the feature cache
    ([B, T, F] float16, or int8 at a fixed scale), which pass through
    with ``sample_lengths`` already holding frame counts."""
    with span(FEATURES_RANGE):
        if samples.dim() == 3:
            if samples.dtype == torch.int8:
                from .data.feature_cache import FEATURE_INT8_SCALE
                return (samples.to(torch.float32)
                        * (1.0 / FEATURE_INT8_SCALE),
                        sample_lengths.to(torch.int32))
            return samples.to(torch.float32), sample_lengths.to(torch.int32)
        samples = decode_wire(samples)
        if cfg.use_pallas:
            from .ops.stft_cuda import stft_features
            feats = stft_features(samples.contiguous(), cfg)
        else:
            feats = plain_features(samples, cfg)
        flens = frame_lengths_from_sample_lengths(sample_lengths, cfg)
        stats = _load_stats(cfg.stats_path) if cfg.stats_path else None
        return (normalize_features(feats, flens, cfg.normalization, stats),
                flens)


@functools.lru_cache(maxsize=8)
def _load_stats(path: str):
    """(mean [F], var [F]) numpy arrays from a compute-stats npz."""
    with np.load(path) as z:
        return (np.asarray(z["mean"], np.float32),
                np.asarray(z["var"], np.float32))


def compute_dataset_stats(manifest, data_cfg, feat_cfg, out_path: str,
                          max_batches: int | None = None,
                          device: str | torch.device = "cuda") -> dict:
    """Accumulate masked per-feature mean/var over a manifest (on
    ``device``, batched via the loader) and save ``mean``, ``var`` and
    ``frames`` to ``out_path``, the npz that ``features.stats_path``
    names (``features.compute_dataset_stats`` of the reference)."""
    import dataclasses

    from .data.loader import DataLoader
    from .ops.dispatch import resolve_device
    dev = resolve_device(device)
    fc = dataclasses.replace(feat_cfg, normalization="none")
    loader = DataLoader(manifest, data_cfg, fc, drop_last=False)
    s = ss = None
    n = 0.0
    for bi, batch in enumerate(loader.iter_epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        feats, flens = extract_features(
            torch.from_numpy(batch.samples[:batch.valid]).to(dev),
            torch.from_numpy(batch.sample_lengths[:batch.valid]).to(dev), fc)
        mask = (torch.arange(feats.shape[1], device=dev)[None, :]
                < flens[:, None]).float()[..., None]
        fsum = torch.sum(feats * mask, dim=(0, 1)).cpu().numpy()
        fsq = torch.sum(torch.square(feats) * mask, dim=(0, 1)).cpu().numpy()
        s = fsum if s is None else s + fsum
        ss = fsq if ss is None else ss + fsq
        n += float(mask.sum())
    mean = s / max(n, 1.0)
    var = np.maximum(ss / max(n, 1.0) - mean * mean, 1e-8)
    np.savez(out_path, mean=mean.astype(np.float32),
             var=var.astype(np.float32), frames=n)
    return {"mean": mean, "var": var, "frames": n}


# ---------------------------------------------------------------------------
# SpecAugment (``features.py:296-353``): train-only time/frequency masking
# of the normalized features. Per-utterance widths and starts come from
# uniforms drawn from an explicit torch.Generator; the mask builder takes
# the uniforms as arguments, so a test can feed it the reference's draws.
# ---------------------------------------------------------------------------

def axis_masks(u_w: torch.Tensor, u_s: torch.Tensor, length: int,
               max_width: torch.Tensor, limit: torch.Tensor,
               pos_start: int = 0) -> torch.Tensor:
    """[B, length] bool: union of the spans of ``u_w``/``u_s`` [B, n]
    (``features._axis_masks``). max_width/limit [B]: per-row maximum
    width and exclusive upper bound for span placement; width-0 spans
    mask nothing. ``pos_start`` is the global index of position 0 (a
    time shard's offset under sequence parallelism)."""
    maxw = torch.minimum(max_width.float(), limit.float())[:, None]
    w = torch.floor(u_w * (maxw + 1.0))                   # [B, n] in [0, maxw]
    lim = limit.float()[:, None]
    s = torch.floor(u_s * torch.clamp_min(lim - w + 1.0, 1.0))
    pos = (float(pos_start) + torch.arange(
        length, dtype=torch.float32, device=u_w.device))[None, None, :]
    spans = (pos >= s[..., None]) & (pos < (s + w)[..., None])
    return spans.any(dim=1)


def spec_augment(feats: torch.Tensor, frame_lengths: torch.Tensor,
                 n_time_masks: int, time_ratio: float, n_freq_masks: int,
                 freq_width: int,
                 generator: torch.Generator | None) -> torch.Tensor:
    """feats [B, T, F] -> masked copy (zeros inside masked spans). Time
    masks are at most ``time_ratio * len`` wide and lie in [0, len);
    frequency masks at most ``freq_width``. ``generator`` lies on the
    features' device; its draws are the time masks' (u_w, u_s), then the
    frequency masks'."""
    B, T, F = feats.shape
    dev = feats.device

    def uniforms(n):
        return (torch.rand((B, n), generator=generator, device=dev),
                torch.rand((B, n), generator=generator, device=dev))

    if n_time_masks > 0:
        lens = frame_lengths.float()
        tm = axis_masks(*uniforms(n_time_masks), T,
                        torch.floor(time_ratio * lens), lens)
        feats = feats * (1.0 - tm.to(feats.dtype))[..., None]
    if n_freq_masks > 0:
        full = torch.full((B,), float(F), device=dev)
        fm = axis_masks(*uniforms(n_freq_masks), F,
                        torch.full((B,), float(freq_width), device=dev), full)
        feats = feats * (1.0 - fm.to(feats.dtype))[:, None, :]
    return feats
