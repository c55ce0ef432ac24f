"""Fused STFT -> power -> mel -> log (-> DCT) frontend: the wrapper of the
CUDA kernel ``csrc/stft.cu`` and its plain PyTorch version.

Replaces ``ctc_asr_tpu/ops/stft_pallas.py`` (``_stft_kernel``, launched
by ``features_pallas``). It computes what the plain path
``features.plain_features`` computes, un-normalized; normalization
stays plain torch, as in the reference.

The kernel evaluates the DFT by an FFT: it packs a frame's ``n_fft``
real samples as ``n_fft / 2`` complex points, runs a radix-8 Stockham
FFT and splits the result into the real spectrum. It takes ``n_fft`` a
power of two from 64 to 2048 (``check_geometry``); for any other the
wrapper raises before any launch.

Host-side preparation (``kernel_constants``, cached per device and
geometry): the Hann window, the twiddle table ``e^{-2 pi i e / n_fft}``
computed in f64 and stored in f32, and the filterbank in a sparse form:
each filter's nonzero bins ``[lo, lo + len)`` with their weights packed
one filter after another. The kernel computes power only up to the last
bin any filter uses (``nb``); the dropped bins have all-zero filterbank
rows, so the kept sums are unchanged (the reference's bin truncation,
``stft_pallas.py:201-213``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FeatureConfig

from .. import features as feat_mod
from . import build
from .dispatch import check_kernel_tensor, require_kernel_device

LOG_FLOOR = 1e-6
MIN_N_FFT, MAX_N_FFT = 64, 2048   # the kernel's FFT sizes (powers of two)


def stft_features_plain(samples: torch.Tensor,
                        cfg: FeatureConfig) -> torch.Tensor:
    """The kernel's plain version: [B, S] f32 -> [B, T, F] f32."""
    return feat_mod.plain_features(samples, cfg)


def check_geometry(cfg: FeatureConfig) -> None:
    """Raise unless the kernel takes ``cfg``: ``n_fft`` a power of two in
    [64, 2048] and a known feature type."""
    n = cfg.n_fft
    if not (MIN_N_FFT <= n <= MAX_N_FFT and n & (n - 1) == 0):
        raise ValueError(
            f"the STFT kernel takes n_fft a power of two from {MIN_N_FFT} "
            f"to {MAX_N_FFT}, got n_fft={n}: set "
            f"--features.use_pallas=false for the plain frontend")
    if cfg.feature_type not in ("mel", "mfcc"):
        raise ValueError(f"unknown feature_type {cfg.feature_type!r}")


@functools.lru_cache(maxsize=8)
def kernel_constants(cfg: FeatureConfig) -> dict:
    """Numpy constants of the kernel: the window [W], the twiddle table
    [n_fft, 2] (cos, -sin of 2 pi e / n_fft), the sparse filterbank
    (``mel_w`` packed weights, ``mel_lo`` [M] first bin, ``mel_off``
    [M+1] offsets into ``mel_w``), ``nb`` bins of power needed, and the
    DCT [M, F] (a 1x1 zero placeholder for log-mel)."""
    check_geometry(cfg)
    n = cfg.n_fft
    fb = feat_mod.mel_filterbank(n, cfg.n_mels, cfg.sample_rate, cfg.fmin,
                                 cfg.fmax)
    lo, off, w = [], [0], []
    for m in range(fb.shape[1]):
        nz = np.nonzero(fb[:, m])[0]
        a, b = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(a)
        w.append(fb[a:b, m])
        off.append(off[-1] + b - a)
    nb = max(1, max(a + off[m + 1] - off[m] for m, a in enumerate(lo)))
    ang = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    use_dct = cfg.feature_type == "mfcc"
    dct = feat_mod.dct_matrix(cfg.n_mels, cfg.n_mfcc) if use_dct \
        else np.zeros((1, 1), np.float32)
    return {
        "window": feat_mod.hann_window(cfg.win_length),
        "twiddle": np.stack([np.cos(ang), -np.sin(ang)],
                            1).astype(np.float32),
        "mel_w": np.concatenate(w).astype(np.float32),
        "mel_lo": np.asarray(lo, np.int32),
        "mel_off": np.asarray(off, np.int32),
        "nb": nb,
        "dct": np.ascontiguousarray(dct),
        "use_dct": use_dct,
    }


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: FeatureConfig, device: torch.device) -> dict:
    c = kernel_constants(cfg)
    return {k: (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v) for k, v in c.items()}


def stft_features(samples: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """[B, S] float32 samples -> [B, T, F] float32 features.

    A CPU tensor gets the plain version; a CUDA tensor launches the
    kernel, or raises before any launch if it cannot (an ``n_fft`` that
    is not a power of two in [64, 2048]: ``check_geometry``)."""
    if samples.device.type == "cpu":
        return stft_features_plain(samples, cfg)
    require_kernel_device(samples)
    check_geometry(cfg)
    B, S = samples.shape
    T = max(1, feat_mod.num_frames(S, cfg))
    check_kernel_tensor("samples", samples, torch.float32, (B, S))
    c = _device_constants(cfg, samples.device)
    M = c["mel_lo"].shape[0]
    F = cfg.feature_dim
    out = torch.empty((B, T, F), dtype=torch.float32, device=samples.device)
    rc = build.load().stft_mel_forward(
        samples.data_ptr(), c["window"].data_ptr(), c["twiddle"].data_ptr(),
        c["mel_w"].data_ptr(), c["mel_lo"].data_ptr(),
        c["mel_off"].data_ptr(), c["dct"].data_ptr(), out.data_ptr(),
        B, S, T, cfg.win_length, cfg.hop_length, cfg.n_fft, c["nb"], M, F,
        c["mel_w"].shape[0], int(c["use_dct"]), LOG_FLOOR,
        torch.cuda.current_stream(samples.device).cuda_stream)
    build.check(rc, "stft_mel_forward")
    stft_features.launches += 1
    return out


stft_features.launches = 0
