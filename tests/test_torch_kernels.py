"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (marked ``cuda``; they skip where there is no device of compute
capability 9.0). Run them on an H100 with:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

This file imports no JAX, so it runs where only PyTorch is installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ctc_asr_tpu.config import FeatureConfig, ModelConfig
from ctc_asr_tpu_torch.models import apply_encoder, init_shapes
from ctc_asr_tpu_torch.ops import lstm_cuda, stft_cuda
from ctc_asr_tpu_torch.ops.dispatch import cuda_supported

pytestmark = pytest.mark.cuda

STFT_TOL = 2e-3   # f32 log-features, sums in another order
LSTM_TOL = 8e-3   # two bf16 ulps of h at |h| in [0.5, 1)


@pytest.fixture
def dev():
    if not cuda_supported():
        pytest.skip("needs a CUDA device of compute capability 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("cfg,B,S", [
    (FeatureConfig(), 3, 16000),
    (FeatureConfig(feature_type="mfcc", n_mels=26, n_mfcc=13), 2, 7777),
    (FeatureConfig(n_mels=40, fmax=8000.0), 2, 9000),   # 257 bins
    (FeatureConfig(), 2, 300),                          # shorter than W
])
def test_stft_kernel_matches_plain(dev, cfg, B, S):
    rng = np.random.default_rng(S)
    x = torch.from_numpy((rng.standard_normal((B, S)) * 0.3)
                         .astype(np.float32)).to(dev)
    n0 = stft_cuda.stft_features.launches
    got = stft_cuda.stft_features(x, cfg)
    want = stft_cuda.stft_features_plain(x, cfg)
    torch.cuda.synchronize()
    assert stft_cuda.stft_features.launches == n0 + 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= STFT_TOL


@pytest.mark.parametrize("nd,T,B,H", [(1, 12, 5, 64), (2, 30, 33, 96),
                                      (2, 7, 3, 48)])
def test_lstm_kernel_matches_plain(dev, nd, T, B, H):
    g = torch.Generator().manual_seed(T)
    xproj = torch.randn(nd, T, B, 4 * H, generator=g).to(torch.bfloat16)
    b = 0.1 * torch.randn(nd, 4 * H, generator=g)
    wh = (0.2 * torch.rand(nd, H, 4 * H, generator=g) - 0.1
          ).to(torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lens[0] = T
    start = torch.stack([torch.zeros_like(lens), T - lens])[:nd]
    end = torch.stack([lens, torch.full_like(lens, T)])[:nd]
    args = [t.to(dev).contiguous() for t in (xproj, b, wh, start, end)]
    got = lstm_cuda.lstm_seq(*args)
    want = lstm_cuda.lstm_seq_plain(*args).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= LSTM_TOL
    t = torch.arange(T, device=dev)[None, :, None]
    outside = (t < args[3][:, None]) | (t >= args[4][:, None])
    assert not got.float().abs().amax(-1)[outside].any()


def test_lstm_kernel_rejects_bad_input(dev):
    x = torch.zeros(1, 4, 2, 64, dtype=torch.float32, device=dev)  # not bf16
    b = torch.zeros(1, 64, device=dev)
    wh = torch.zeros(1, 16, 64, dtype=torch.bfloat16, device=dev)
    se = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        lstm_cuda.lstm_seq(x, b, wh, se, se)


def test_encoder_kernel_path_matches_plain_path(dev):
    cfg = ModelConfig(frontend="conv", conv_channels=(8, 8), rnn_layers=2,
                      rnn_units=64, bidirectional=True, dropout=0.0,
                      compute_dtype="float32")
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(rng.uniform(-0.1, 0.1, s)
                                  .astype(np.float32)).to(dev)
              for k, s in init_shapes(cfg, 40).items()}
    feats = torch.from_numpy(rng.standard_normal((4, 50, 40))
                             .astype(np.float32)).to(dev)
    flens = torch.tensor([50, 31, 7, 1], dtype=torch.int32, device=dev)
    n0 = lstm_cuda.lstm_seq.launches
    with torch.inference_mode():
        lk, lens_k = apply_encoder(params, feats, flens, cfg)
        lp, lens_p = apply_encoder(
            params, feats, flens,
            dataclasses.replace(cfg, use_pallas_rnn=False))
    assert lstm_cuda.lstm_seq.launches == n0 + 2
    assert torch.equal(lens_k, lens_p)
    # kernel path: bf16 xproj / wh; plain path at f32 compute
    assert (lk - lp).abs().max().item() <= 2e-2
