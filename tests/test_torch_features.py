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


@pytest.mark.parametrize("cfg", [
    FeatureConfig(), FeatureConfig(feature_type="mfcc", n_mels=26),
    FeatureConfig(n_mels=40, fmax=8000.0),   # no bin truncation
])
def test_kernel_constants_reproduce_plain_path(cfg):
    """The truncated, window-folded bases the CUDA kernel consumes give
    the plain path's features (a numpy model of the kernel's math)."""
    c = stft_cuda.kernel_constants(cfg)
    x = _signal(2, 9000, seed=5)
    frames = tf.frame_signal(torch.from_numpy(x), cfg).double().numpy()
    power = (frames @ c["cos"]) ** 2 + (frames @ c["sin"]) ** 2
    feats = np.log(np.maximum(power @ c["mel"], stft_cuda.LOG_FLOOR))
    if c["use_dct"]:
        feats = feats @ c["dct"]
    want = tf.plain_features(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(feats, want, rtol=TOL, atol=TOL)
    assert c["cos"].shape[1] == (256 if cfg.fmax < 8000 else 257)


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
