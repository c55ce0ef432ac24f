"""The port's feature frontend (ctc_asr_tpu_torch.features and the STFT
kernel wrapper's CPU path) held against the JAX reference on the CPU.

Inputs come from numpy seeds and go to both packages. Tolerance 2e-4 in
f32 unless stated; frame counts and constants must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctc_asr_tpu import features as jf
from ctc_asr_tpu.audio import float_to_ulaw, float_to_wire16
from ctc_asr_tpu.config import FeatureConfig
from ctc_asr_tpu.ops.stft_pallas import features_pallas
from ctc_asr_tpu_torch import features as tf
from ctc_asr_tpu_torch.ops import stft_cuda

TOL = 2e-4


def _signal(B, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    f = rng.uniform(200, 3000, (B, 1))
    return (0.3 * np.sin(2 * np.pi * f * t)
            + 0.05 * rng.standard_normal((B, n))).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("dft_matrices", (400, 512)), ("dft_matrices", (256, 256)),
    ("hann_window", (400,)), ("hann_window", (512,)),
    ("mel_filterbank", (512, 80, 16000, 20.0, 7600.0)),
    ("mel_filterbank", (512, 40, 16000, 0.0, 8000.0)),
    ("mel_filterbank", (1024, 64, 22050, 50.0, 9000.0)),
    ("dct_matrix", (80, 13)), ("dct_matrix", (26, 13)), ("dct_matrix", (40, 1)),
])
def test_constants_equal(name, args):
    want = getattr(jf, name)(*args)
    got = getattr(tf, name)(*args)
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


def test_frame_lengths_exact():
    cfg = FeatureConfig()
    lens = np.array([0, 1, 399, 400, 401, 559, 560, 16000, 128000, 7],
                    np.int32)
    want = np.asarray(jf.frame_lengths_from_sample_lengths(
        jnp.asarray(lens), cfg))
    np.testing.assert_array_equal(
        tf.frame_lengths_from_sample_lengths(torch.from_numpy(lens),
                                             cfg).numpy(), want)
    np.testing.assert_array_equal(
        tf.frame_lengths_from_sample_lengths(lens, cfg), want)
    for n in (0, 300, 400, 16000):
        assert tf.num_frames(n, cfg) == jf.num_frames(n, cfg)


@pytest.mark.parametrize("feature_type,n", [
    ("mel", 16000), ("mfcc", 12345),
    ("mel", 250),     # shorter than one window: the index clamp
])
def test_features_match_reference(feature_type, n):
    cfg = FeatureConfig(feature_type=feature_type, n_mels=40, n_mfcc=13)
    x = _signal(2, n, seed=n)
    want = np.asarray(jf._jnp_features(jnp.asarray(x), cfg))
    got = tf.plain_features(torch.from_numpy(x), cfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("feature_type", ["mel", "mfcc"])
def test_plain_path_matches_pallas_kernel(feature_type):
    """Plain path and the kernel wrapper's CPU path against the Pallas
    kernel in interpret mode, at the Pallas tests' 2e-3
    (tests/test_stft_pallas.py: the kernel's hop-row sums run in
    another order)."""
    cfg = FeatureConfig(feature_type=feature_type, n_mels=40)
    x = _signal(2, 20000, seed=3)
    want = np.asarray(features_pallas(jnp.asarray(x), cfg, interpret=True))
    for got in (tf.plain_features(torch.from_numpy(x), cfg),
                stft_cuda.stft_features(torch.from_numpy(x), cfg)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def _fft_radices(n_fft: int) -> tuple[int, ...]:
    """csrc/stft.cu's passes over the n_fft/2-point FFT (``Plan``): radix
    8 while three or more bits are left, then one of 4 or 2."""
    bits = (n_fft // 2).bit_length() - 1
    return (8,) * (bits // 3) + {0: (), 1: (2,), 2: (4,)}[bits % 3]


def _kernel_model(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """A numpy model of csrc/stft.cu built from ``kernel_constants``:
    window (folded mod n_fft where W > n_fft), the packing z[p] =
    x[2p] + i x[2p+1], the Stockham passes in the kernel's order with
    its twiddle table, the real split, the sparse mel ranges, the log
    floor and the DCT. [B, S] -> [B, T, F]."""
    c = stft_cuda.kernel_constants(cfg)
    n, nh = cfg.n_fft, cfg.n_fft // 2
    tw = c["twiddle"][:, 0].astype(np.float64) + 1j * c["twiddle"][:, 1]
    frames = tf.frame_signal(torch.from_numpy(x), cfg).double().numpy()
    xw = frames * c["window"]
    W = xw.shape[-1]
    xw = np.pad(xw, [(0, 0)] * (xw.ndim - 1) + [(0, -W % n)])
    xw = xw.reshape(*xw.shape[:-1], -1, n).sum(-2)          # the fold
    z = xw[..., 0::2] + 1j * xw[..., 1::2]                  # [B, T, nh]
    ns = 1
    for R in _fft_radices(n):
        bf = np.arange(nh // R)
        k = bf % ns
        r = np.arange(R)
        v = z[..., bf[:, None] + r * (nh // R)]
        v = v * tw[r[None, :] * k[:, None] * (n // (ns * R))]
        v = np.fft.fft(v, axis=-1)                          # radix-R DFT
        z = np.empty_like(z)
        z[..., ((bf // ns) * ns * R + k)[:, None] + r * ns] = v
        ns *= R
    ref = np.fft.fft(xw[..., 0::2] + 1j * xw[..., 1::2])
    # the passes are the FFT, up to the f32 twiddles' rounding
    assert np.abs(z - ref).max() <= 1e-5 * np.abs(ref).max()
    kb = np.arange(c["nb"])
    zk, zc = z[..., kb % nh], np.conj(z[..., (nh - kb) % nh])
    spec = 0.5 * ((zk + zc) + tw[kb] * (-1j) * (zk - zc))
    power = spec.real ** 2 + spec.imag ** 2
    lo, off = c["mel_lo"], c["mel_off"]
    mel = np.stack([power[..., lo[m]:lo[m] + off[m + 1] - off[m]]
                    @ c["mel_w"][off[m]:off[m + 1]]
                    for m in range(len(lo))], -1)
    feats = np.log(np.maximum(mel, stft_cuda.LOG_FLOOR))
    return feats @ c["dct"] if c["use_dct"] else feats


@pytest.mark.parametrize("cfg", [
    FeatureConfig(), FeatureConfig(feature_type="mfcc", n_mels=26),
    FeatureConfig(n_mels=40, fmax=8000.0),   # 257 bins: Nyquist included
    FeatureConfig(n_fft=256),                # W=400 > n_fft: folded
    FeatureConfig(n_fft=1024),
    FeatureConfig(n_fft=64, n_mels=20),      # fewer butterflies than lanes
    FeatureConfig(n_fft=2048, feature_type="mfcc", n_mels=40),
])
def test_kernel_constants_reproduce_plain_path(cfg):
    """The kernel's algorithm on its host constants (a numpy model of
    csrc/stft.cu) gives the plain path's features."""
    c = stft_cuda.kernel_constants(cfg)
    x = _signal(2, 9000, seed=5)
    want = tf.plain_features(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(_kernel_model(x, cfg), want, rtol=TOL,
                               atol=TOL)
    fb = tf.mel_filterbank(cfg.n_fft, cfg.n_mels, cfg.sample_rate, cfg.fmin,
                           cfg.fmax)
    assert c["nb"] == np.nonzero(fb.any(axis=1))[0][-1] + 1
    assert (c["nb"] == cfg.n_fft // 2 + 1) == (cfg.fmax >= 8000)
    assert np.prod(_fft_radices(cfg.n_fft)) == cfg.n_fft // 2


def test_kernel_sparse_mel_is_the_filterbank():
    """Each filter's packed weights are its nonzero column; every bin
    feeds at most two filters, so the weights are at most 2 * nb."""
    cfg = FeatureConfig()
    c = stft_cuda.kernel_constants(cfg)
    fb = tf.mel_filterbank(cfg.n_fft, cfg.n_mels, cfg.sample_rate, cfg.fmin,
                           cfg.fmax)
    dense = np.zeros_like(fb)
    for m, lo in enumerate(c["mel_lo"]):
        w = c["mel_w"][c["mel_off"][m]:c["mel_off"][m + 1]]
        dense[lo:lo + len(w), m] = w
    np.testing.assert_array_equal(dense, fb)
    assert len(c["mel_w"]) <= 2 * c["nb"]
    assert ((fb != 0).sum(axis=1) <= 2).all()


@pytest.mark.parametrize("n_fft", [32, 4096, 48, 3000])
def test_geometry_refuses_unsupported_n_fft(n_fft):
    """An n_fft outside 64-2048 is taken by neither kernel: refused on the
    host, before any launch, naming the plain frontend's switch; the
    plain path itself takes it."""
    cfg = FeatureConfig(n_fft=n_fft)
    with pytest.raises(ValueError, match="features.use_pallas=false"):
        stft_cuda.check_geometry(cfg)
    with pytest.raises(ValueError, match="features.use_pallas=false"):
        stft_cuda.kernel_constants(cfg)
    x = torch.from_numpy(_signal(1, 4000, seed=1))
    assert stft_cuda.stft_features(x, cfg).shape == \
        tf.plain_features(x, cfg).shape


def test_geometry_refuses_a_direct_dft_block_that_does_not_fit():
    """The direct DFT stages 32 frames' samples, power and log-mels in
    shared memory: a hop of 100 ms at n_fft=400 needs more than a block's
    227 KB and is refused; at 60 ms it fits."""
    wide = FeatureConfig(n_fft=400, hop_ms=100.0)
    assert stft_cuda.dft_smem_bytes(wide) > stft_cuda.MAX_BLOCK_SMEM
    with pytest.raises(ValueError, match="features.use_pallas=false"):
        stft_cuda.check_geometry(wide)
    assert stft_cuda.check_geometry(FeatureConfig(n_fft=400,
                                                  hop_ms=60.0)) == "dft"


def _dft_kernel_model(x: np.ndarray, cfg: FeatureConfig) -> np.ndarray:
    """A numpy model of csrc/stft_dft.cu built from ``kernel_constants``:
    frames against the windowed bases, power, the dense mel product over
    the nb bins, the log floor and the DCT. [B, S] -> [B, T, F]."""
    c = stft_cuda.kernel_constants(cfg)
    frames = tf.frame_signal(torch.from_numpy(x), cfg).double().numpy()
    power = (frames @ c["cos"]) ** 2 + (frames @ c["sin"]) ** 2
    feats = np.log(np.maximum(power @ c["mel"], stft_cuda.LOG_FLOOR))
    return feats @ c["dct"] if c["use_dct"] else feats


@pytest.mark.parametrize("n_fft", [400, 320])
def test_geometry_routes_other_n_fft_to_the_direct_dft(n_fft):
    """A size that is not a power of two goes to the direct-DFT kernel,
    whose constants are the reference's windowed DFT bases and filterbank
    cut to the bins the filters use; its algorithm on them gives the
    reference's features (and the plain path's). Powers of two keep the
    FFT."""
    cfg = FeatureConfig(n_fft=n_fft)
    assert stft_cuda.check_geometry(cfg) == "dft"
    assert stft_cuda.check_geometry(FeatureConfig(n_fft=512)) == "fft"
    c = stft_cuda.kernel_constants(cfg)
    assert c["route"] == "dft"
    cos_m, msin_m = jf.dft_matrices(cfg.win_length, n_fft)
    win = jf.hann_window(cfg.win_length)[:, None]
    fb = jf.mel_filterbank(n_fft, cfg.n_mels, cfg.sample_rate, cfg.fmin,
                           cfg.fmax)
    nb = c["nb"]
    assert nb == np.nonzero(fb.any(axis=1))[0][-1] + 1
    np.testing.assert_array_equal(c["cos"], (win * cos_m)[:, :nb])
    np.testing.assert_array_equal(c["sin"], (win * msin_m)[:, :nb])
    np.testing.assert_array_equal(c["mel"], fb[:nb])
    x = _signal(2, 9000, seed=n_fft)
    want = np.asarray(jf.log_mel_spectrogram(jnp.asarray(x), cfg))
    got = _dft_kernel_model(x, cfg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got, tf.plain_features(torch.from_numpy(x), cfg).numpy(), rtol=TOL,
        atol=TOL)


@pytest.mark.parametrize("mode,with_stats", [
    ("utterance", False), ("global", False), ("global", True),
    ("none", False)])
def test_normalization_modes(mode, with_stats):
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((3, 20, 6)).astype(np.float32) * 3 + 1
    flens = np.array([20, 7, 0], np.int32)
    stats = (rng.standard_normal(6).astype(np.float32),
             rng.uniform(0.5, 2, 6).astype(np.float32)) if with_stats \
        else None
    want = np.asarray(jf.normalize_features(
        jnp.asarray(feats), jnp.asarray(flens), mode, stats))
    got = tf.normalize_features(torch.from_numpy(feats),
                                torch.from_numpy(flens), mode, stats).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert not got[1, 7:].any() and not got[2].any()


@pytest.mark.parametrize("wire", ["float32", "int16", "ulaw"])
def test_extract_features_wire(wire):
    cfg = FeatureConfig(n_mels=32, use_pallas=False)
    x = _signal(2, 8000, seed=11)
    if wire == "int16":
        x = float_to_wire16(x)
    elif wire == "ulaw":
        x = float_to_ulaw(x)
    lens = np.array([8000, 3001], np.int32)
    fw, lw = jf.extract_features(jnp.asarray(x), jnp.asarray(lens), cfg)
    fg, lg = tf.extract_features(torch.from_numpy(x), torch.from_numpy(lens),
                                 cfg)
    np.testing.assert_array_equal(lg.numpy(), np.asarray(lw))
    np.testing.assert_allclose(fg.numpy(), np.asarray(fw), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dtype", [np.int8, np.float16])
def test_extract_features_cache_passthrough(dtype):
    rng = np.random.default_rng(2)
    feats = (rng.standard_normal((2, 9, 5)) * 20).astype(dtype)
    flens = np.array([9, 4], np.int32)
    fw, lw = jf.extract_features(jnp.asarray(feats), jnp.asarray(flens),
                                 FeatureConfig())
    fg, lg = tf.extract_features(torch.from_numpy(feats),
                                 torch.from_numpy(flens), FeatureConfig())
    assert fg.dtype == torch.float32
    np.testing.assert_array_equal(lg.numpy(), np.asarray(lw))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(fw))
