"""Fused STFT -> power -> mel -> log (-> DCT) frontend: the wrapper of the
CUDA kernel ``csrc/stft.cu`` and its plain PyTorch version.

Replaces ``ctc_asr_tpu/ops/stft_pallas.py`` (``_stft_kernel``, launched
by ``features_pallas``). It computes what the plain path
``features.plain_features`` computes, un-normalized; normalization
stays plain torch, as in the reference.

Host-side preparation (cached per device and geometry): the Hann window
is folded into the cos / -sin DFT bases, and the DFT stops at the last
FFT bin any mel filter uses, rounded up to 128 bins — the reference's
exact bin truncation (``stft_pallas.py:201-213``): the dropped bins have
all-zero filterbank rows, so the kept sums are unchanged.
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


def stft_features_plain(samples: torch.Tensor,
                        cfg: FeatureConfig) -> torch.Tensor:
    """The kernel's plain version: [B, S] f32 -> [B, T, F] f32."""
    return feat_mod.plain_features(samples, cfg)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=8)
def kernel_constants(cfg: FeatureConfig) -> dict:
    """Numpy constants of the kernel: windowed bases [W, NB], mel
    [NB, M] and DCT [M, F] (a 1x1 zero placeholder for log-mel)."""
    W = cfg.win_length
    cos_m, msin_m = feat_mod.dft_matrices(W, cfg.n_fft)
    win = feat_mod.hann_window(W)
    fb = feat_mod.mel_filterbank(cfg.n_fft, cfg.n_mels, cfg.sample_rate,
                                 cfg.fmin, cfg.fmax)
    nz = np.nonzero((fb != 0).any(axis=1))[0]
    used = int(nz[-1]) + 1 if nz.size else fb.shape[0]
    nb = min(fb.shape[0], _round_up(used, 128))
    use_dct = cfg.feature_type == "mfcc"
    dct = feat_mod.dct_matrix(cfg.n_mels, cfg.n_mfcc) if use_dct \
        else np.zeros((1, 1), np.float32)
    return {
        "cos": np.ascontiguousarray((win[:, None] * cos_m)[:, :nb]),
        "sin": np.ascontiguousarray((win[:, None] * msin_m)[:, :nb]),
        "mel": np.ascontiguousarray(fb[:nb]),
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
    kernel (and raises if it cannot)."""
    if samples.device.type == "cpu":
        return stft_features_plain(samples, cfg)
    require_kernel_device(samples)
    if cfg.feature_type not in ("mel", "mfcc"):
        raise ValueError(f"unknown feature_type {cfg.feature_type!r}")
    B, S = samples.shape
    T = max(1, feat_mod.num_frames(S, cfg))
    check_kernel_tensor("samples", samples, torch.float32, (B, S))
    c = _device_constants(cfg, samples.device)
    W, NB = c["cos"].shape
    M = c["mel"].shape[1]
    F = cfg.feature_dim
    out = torch.empty((B, T, F), dtype=torch.float32, device=samples.device)
    lib = build.load()
    rc = lib.stft_mel_forward(
        samples.data_ptr(), c["cos"].data_ptr(), c["sin"].data_ptr(),
        c["mel"].data_ptr(), c["dct"].data_ptr(), out.data_ptr(),
        B, S, T, W, cfg.hop_length, NB, M, F, int(c["use_dct"]), LOG_FLOOR,
        torch.cuda.current_stream(samples.device).cuda_stream)
    build.check(rc, "stft_mel_forward")
    stft_features.launches += 1
    return out


stft_features.launches = 0
