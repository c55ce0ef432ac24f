"""Fused STFT -> power -> mel -> log (-> DCT) frontend: the wrapper of the
CUDA kernel ``csrc/stft.cu`` and its plain PyTorch version.

Replaces ``ctc_asr_tpu/ops/stft_pallas.py`` (``_stft_kernel``, launched
by ``features_pallas``). It computes what the plain path
``features.plain_features`` computes, un-normalized; normalization
stays plain torch, as in the reference.

Two kernels, chosen by the geometry alone (``check_geometry``), for
``n_fft`` from 64 to 2048:

- a power of two: ``csrc/stft.cu`` evaluates the DFT by an FFT. It packs
  a frame's ``n_fft`` real samples as ``n_fft / 2`` complex points, runs
  a radix-8 Stockham FFT and splits the result into the real spectrum;
- any other size: ``csrc/stft_dft.cu`` evaluates it directly against
  windowed cos / -sin bases, as the reference's kernel does for every
  size, where its shared memory (``dft_smem_bytes``) fits a block. At
  the presets' 25 ms window, 10 ms hop and 80 mels that is every size up
  to 2047 (156,224 bytes of the 232,448); at n_fft=400 a hop up to
  ~95 ms.

Anything else is refused before any launch. Neither kernel gives way to
the other, nor to the plain version, after a failure.

Host-side preparation (``kernel_constants``, cached per device and
geometry). FFT: the Hann window, the twiddle table ``e^{-2 pi i e /
n_fft}`` computed in f64 and stored in f32, and the filterbank in a
sparse form: each filter's nonzero bins ``[lo, lo + len)`` with their
weights packed one filter after another. Direct DFT: the reference's
bases ``features.dft_matrices`` with the window folded in, and the dense
filterbank. Both compute power only up to the last bin any filter uses
(``nb``); the dropped bins have all-zero filterbank rows, so the kept
sums are unchanged (the reference's bin truncation,
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
MIN_N_FFT, MAX_N_FFT = 64, 2048   # the sizes either kernel is offered
DFT_FRAMES = 32                   # frames a block of the direct DFT (FT)
MAX_BLOCK_SMEM = 232448           # shared bytes an H100 block may use


def stft_features_plain(samples: torch.Tensor,
                        cfg: FeatureConfig) -> torch.Tensor:
    """The kernels' plain version: [B, S] f32 -> [B, T, F] f32."""
    return feat_mod.plain_features(samples, cfg)


def _filterbank(cfg: FeatureConfig) -> tuple[np.ndarray, int]:
    """The mel filterbank [n_fft/2+1, M] and ``nb``, the last bin any
    filter uses plus one."""
    fb = feat_mod.mel_filterbank(cfg.n_fft, cfg.n_mels, cfg.sample_rate,
                                 cfg.fmin, cfg.fmax)
    nz = np.nonzero((fb != 0).any(axis=1))[0]
    return fb, (int(nz[-1]) + 1 if nz.size else 1)


def dft_smem_bytes(cfg: FeatureConfig) -> int:
    """Shared memory of a direct-DFT block (``csrc/stft_dft.cu``): the
    frames' sample span, their power [FT, nb] and log-mels [FT, M]."""
    span = (DFT_FRAMES - 1) * cfg.hop_length + cfg.win_length
    nb = _filterbank(cfg)[1]
    return 4 * (span + DFT_FRAMES * nb + DFT_FRAMES * cfg.n_mels)


def check_geometry(cfg: FeatureConfig) -> str:
    """The kernel that takes ``cfg``: ``"fft"`` for ``n_fft`` a power of
    two in [64, 2048], ``"dft"`` for any other size in that range whose
    direct-DFT block fits the shared memory; raise for anything else or
    an unknown feature type."""
    if cfg.feature_type not in ("mel", "mfcc"):
        raise ValueError(f"unknown feature_type {cfg.feature_type!r}")
    n = cfg.n_fft
    if MIN_N_FFT <= n <= MAX_N_FFT:
        if n & (n - 1) == 0:
            return "fft"
        if dft_smem_bytes(cfg) <= MAX_BLOCK_SMEM:
            return "dft"
    raise ValueError(
        f"the STFT kernels take n_fft from {MIN_N_FFT} to {MAX_N_FFT} (a "
        f"power of two by an FFT, any other size by a direct DFT whose "
        f"block needs at most {MAX_BLOCK_SMEM} bytes of shared memory), got "
        f"n_fft={n} (hop {cfg.hop_length}, window {cfg.win_length}): set "
        f"--features.use_pallas=false for the plain frontend")


@functools.lru_cache(maxsize=8)
def kernel_constants(cfg: FeatureConfig) -> dict:
    """Numpy constants of the kernel ``check_geometry`` picks, under
    ``route``. FFT: the window [W], the twiddle table [n_fft, 2] (cos,
    -sin of 2 pi e / n_fft), the sparse filterbank (``mel_w`` packed
    weights, ``mel_lo`` [M] first bin, ``mel_off`` [M+1] offsets into
    ``mel_w``). Direct DFT: the windowed bases ``cos`` / ``sin`` [W, nb]
    and the filterbank ``mel`` [nb, M]. Both: ``nb`` bins of power
    needed and the DCT [M, F] (a 1x1 zero placeholder for log-mel)."""
    route = check_geometry(cfg)
    n = cfg.n_fft
    fb, nb = _filterbank(cfg)
    use_dct = cfg.feature_type == "mfcc"
    dct = feat_mod.dct_matrix(cfg.n_mels, cfg.n_mfcc) if use_dct \
        else np.zeros((1, 1), np.float32)
    common = {"route": route, "nb": nb, "dct": np.ascontiguousarray(dct),
              "use_dct": use_dct}
    win = feat_mod.hann_window(cfg.win_length)
    if route == "dft":
        cos_m, msin_m = feat_mod.dft_matrices(cfg.win_length, n)
        return {"cos": np.ascontiguousarray((win[:, None] * cos_m)[:, :nb]),
                "sin": np.ascontiguousarray((win[:, None] * msin_m)[:, :nb]),
                "mel": np.ascontiguousarray(fb[:nb]), **common}
    lo, off, w = [], [0], []
    for m in range(fb.shape[1]):
        nz = np.nonzero(fb[:, m])[0]
        a, b = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(a)
        w.append(fb[a:b, m])
        off.append(off[-1] + b - a)
    ang = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return {
        "window": win,
        "twiddle": np.stack([np.cos(ang), -np.sin(ang)],
                            1).astype(np.float32),
        "mel_w": np.concatenate(w).astype(np.float32),
        "mel_lo": np.asarray(lo, np.int32),
        "mel_off": np.asarray(off, np.int32),
        **common,
    }


@functools.lru_cache(maxsize=16)
def _device_constants(cfg: FeatureConfig, device: torch.device) -> dict:
    c = kernel_constants(cfg)
    return {k: (torch.as_tensor(v, device=device)
                if isinstance(v, np.ndarray) else v) for k, v in c.items()}


def stft_features(samples: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """[B, S] float32 samples -> [B, T, F] float32 features.

    A CPU tensor gets the plain version; a CUDA tensor launches the
    kernel ``check_geometry`` picks, or raises before any launch if
    neither takes ``cfg``. ``launches`` counts both kernels' launches,
    ``dft_launches`` the direct DFT's alone."""
    if samples.device.type == "cpu":
        return stft_features_plain(samples, cfg)
    require_kernel_device(samples)
    check_geometry(cfg)
    B, S = samples.shape
    T = max(1, feat_mod.num_frames(S, cfg))
    check_kernel_tensor("samples", samples, torch.float32, (B, S))
    c = _device_constants(cfg, samples.device)
    M = cfg.n_mels
    F = cfg.feature_dim
    out = torch.empty((B, T, F), dtype=torch.float32, device=samples.device)
    stream = torch.cuda.current_stream(samples.device).cuda_stream
    if c["route"] == "dft":
        rc = build.load().stft_dft_forward(
            samples.data_ptr(), c["cos"].data_ptr(), c["sin"].data_ptr(),
            c["mel"].data_ptr(), c["dct"].data_ptr(), out.data_ptr(), B, S,
            T, cfg.win_length, cfg.hop_length, c["nb"], M, F,
            int(c["use_dct"]), LOG_FLOOR, stream)
        build.check(rc, "stft_dft_forward")
        stft_features.dft_launches += 1
    else:
        rc = build.load().stft_mel_forward(
            samples.data_ptr(), c["window"].data_ptr(),
            c["twiddle"].data_ptr(), c["mel_w"].data_ptr(),
            c["mel_lo"].data_ptr(), c["mel_off"].data_ptr(),
            c["dct"].data_ptr(), out.data_ptr(), B, S, T, cfg.win_length,
            cfg.hop_length, cfg.n_fft, c["nb"], M, F, c["mel_w"].shape[0],
            int(c["use_dct"]), LOG_FLOOR, stream)
        build.check(rc, "stft_mel_forward")
    stft_features.launches += 1
    return out


stft_features.launches = 0
stft_features.dft_launches = 0
