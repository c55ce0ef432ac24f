"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (marked ``cuda``; they skip where there is no device of compute
capability 9.0). Run them on an H100 with:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

This file imports no JAX and nothing of the JAX package, so it runs
where only PyTorch is installed.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from beam_select_cases import SELECT_CASES, select_case
from ctc_asr_tpu_torch import train as train_mod
from ctc_asr_tpu_torch.config import FeatureConfig, ModelConfig, preset
from ctc_asr_tpu_torch.models import apply_encoder, conformer, init_shapes
from ctc_asr_tpu_torch.ops import (attention_cuda, beam_cuda, ctc_cuda,
                                   gru_cuda, lstm_cuda, stft_cuda)
from ctc_asr_tpu_torch.ops.dispatch import cuda_supported
from ctc_asr_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

STFT_TOL = 2e-3   # f32 log-features, sums in another order
LSTM_TOL = 8e-3   # two bf16 ulps of h at |h| in [0.5, 1)
CTC_TOL = 1e-4    # f32 log-space DP, same operation order per state
# K9 against the plain core in f32: the largest error over the largest
# magnitude (at least 0.01: at T' = 1 the gradients of q, k and p are 0
# but for rounding), two bf16 ulps; the plain core in bf16 reads up to
# 1.4e-2 at these shapes
ATT_TOL = 1.6e-2


@pytest.fixture
def dev():
    if not cuda_supported():
        pytest.skip("needs a CUDA device of compute capability 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("cfg,B,S,amp,tail", [
    (FeatureConfig(), 3, 16000, 0.3, 0),
    (FeatureConfig(feature_type="mfcc", n_mels=26, n_mfcc=13), 2, 7777, 0.3,
     0),
    (FeatureConfig(n_mels=40, fmax=8000.0), 2, 9000, 0.3, 0),   # 257 bins
    (FeatureConfig(), 2, 300, 0.3, 0),                  # shorter than W
    (FeatureConfig(n_fft=256), 2, 9000, 0.3, 0),        # W=400: folded
    (FeatureConfig(n_fft=1024), 2, 9000, 0.3, 0),
    # low energy and an all-zero tail, where the log amplifies any error
    (FeatureConfig(), 2, 16000, 1e-4, 6000),
])
def test_stft_kernel_matches_plain(dev, cfg, B, S, amp, tail):
    rng = np.random.default_rng(S)
    x = (rng.standard_normal((B, S)) * amp).astype(np.float32)
    x[:, S - tail:] = 0.0
    x = torch.from_numpy(x).to(dev)
    n0 = stft_cuda.stft_features.launches
    got = stft_cuda.stft_features(x, cfg)
    want = stft_cuda.stft_features_plain(x, cfg)
    torch.cuda.synchronize()
    assert stft_cuda.stft_features.launches == n0 + 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= STFT_TOL


def test_stft_kernel_refuses_n_fft_before_any_launch(dev, monkeypatch):
    """A geometry neither STFT kernel takes (n_fft outside 64-2048, or a
    direct-DFT block above the shared memory) raises on a CUDA tensor
    before any launch, naming the plain frontend's switch; the plain
    version never sees the CUDA tensor."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(stft_cuda, "stft_features_plain", refuse)
    x = torch.zeros(2, 9000, device=dev)
    for cfg in (FeatureConfig(n_fft=4096), FeatureConfig(n_fft=32),
                FeatureConfig(n_fft=400, hop_ms=100.0)):
        n0 = stft_cuda.stft_features.launches
        with pytest.raises(ValueError, match="features.use_pallas=false"):
            stft_cuda.stft_features(x, cfg)
        assert stft_cuda.stft_features.launches == n0


@pytest.mark.parametrize("cfg,B,S", [
    (FeatureConfig(n_fft=400), 3, 16000),
    (FeatureConfig(n_fft=320), 2, 9000),
    (FeatureConfig(n_fft=400, feature_type="mfcc", n_mels=26, n_mfcc=13), 2,
     7777),
    (FeatureConfig(n_fft=400), 2, 300),                 # shorter than W
])
def test_stft_direct_dft_matches_plain(dev, cfg, B, S):
    """An n_fft that is not a power of two launches the direct-DFT kernel
    (one launch, counted by both counters) and agrees with the plain
    version."""
    rng = np.random.default_rng(S)
    x = torch.from_numpy((rng.standard_normal((B, S)) * 0.3
                          ).astype(np.float32)).to(dev)
    want = stft_cuda.stft_features_plain(x, cfg)
    n0 = stft_cuda.stft_features.launches
    d0 = stft_cuda.stft_features.dft_launches
    got = stft_cuda.stft_features(x, cfg)
    torch.cuda.synchronize()
    assert stft_cuda.stft_features.launches == n0 + 1
    assert stft_cuda.stft_features.dft_launches == d0 + 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= STFT_TOL


@pytest.mark.parametrize("form", ["conv2d_matmul_apply",
                                  "conv2d_blocked_apply"])
@pytest.mark.parametrize("B,T", [(128, 798), (16, 350)])
def test_banded_convs_match_the_2d_conv(dev, form, B, T):
    """conv_bilstm3's frontend (conv 1 -> clipped ReLU -> conv 2) at the
    train step's and the serving batch's shapes: the banded form against
    the 2-D conv, both in f32, then in bf16 against the f32 2-D conv at
    chip_smoke's limits. Gradients of both kernels and biases, so also of
    conv 2's input. In f32 only the order of the sums differs: outputs
    within 1e-4 of the largest; a kernel gradient sums ~2M products
    (conv 1's gated by the ReLU, where a conv 1 output within rounding of
    0 may flip), measured 1.1e-3 of its largest at B=128: limit 5e-3."""
    from chip_smoke import (CONV_GRAD_RTOL, CONV_VALUE_RTOL, _conv_chain,
                            _rel_err)
    from ctc_asr_tpu_torch.config import preset
    from ctc_asr_tpu_torch.models import layers
    from ctc_asr_tpu_torch.models.encoder import init_params
    mcfg = preset("conv_bilstm3").model
    params = init_params(mcfg, 80, torch.Generator().manual_seed(B))
    x = torch.randn(B, T, 80, 1, generator=torch.Generator().manual_seed(T)
                    ).to(dev)
    runs, dy = {}, None
    for name, fn, dt in (("2-D f32", layers.conv2d_apply, torch.float32),
                         ("f32", getattr(layers, form), torch.float32),
                         ("bf16", getattr(layers, form), torch.bfloat16)):
        leaves = [params[f"frontend/{i}/{k}"].to(dev).requires_grad_()
                  for i in (0, 1) for k in ("w", "b")]
        y = _conv_chain(fn, {"w": leaves[0], "b": leaves[1]},
                        {"w": leaves[2], "b": leaves[3]}, x, mcfg, dt)
        if dy is None:
            dy = torch.randn(y.shape, generator=torch.Generator(
                ).manual_seed(1)).to(dev)
        runs[name] = (y.detach(), torch.autograd.grad(y, leaves, dy))
    (want, want_g) = runs["2-D f32"]
    for name, v_tol, g_tol in (("f32", 1e-4, 5e-3),
                               ("bf16", CONV_VALUE_RTOL, CONV_GRAD_RTOL)):
        got, got_g = runs[name]
        assert got.shape == want.shape
        assert _rel_err(got, want) <= v_tol, name
        for leaf, a, b in zip(("w1", "b1", "w2", "b2"), got_g, want_g):
            assert _rel_err(a, b) <= g_tol, (name, leaf)


def _lens_case(T, B, g):
    """Ragged lengths with a full row, then (where B allows) a length-1
    and an empty row."""
    lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    if B:
        lens[0] = T
    if B > 2:
        lens[1], lens[2] = 1, 0
    return lens


# T = 2 and 3 come first: a step barrier that deadlocks shows there
@pytest.mark.parametrize("nd,T,B,H", [(2, 2, 3, 48), (2, 3, 33, 96),
                                      (1, 1, 5, 64), (1, 12, 5, 64),
                                      (2, 30, 33, 96), (2, 7, 3, 48),
                                      (2, 9, 1, 16), (1, 20, 70, 16),
                                      (2, 40, 16, 800), (2, 399, 128, 800),
                                      (2, 175, 16, 800), (2, 175, 1, 800),
                                      (2, 60, 128, 512), (1, 25, 200, 512)])
def test_lstm_kernel_matches_plain(dev, nd, T, B, H):
    g = torch.Generator().manual_seed(T)
    xproj = torch.randn(nd, T, B, 4 * H, generator=g).to(torch.bfloat16)
    b = 0.1 * torch.randn(nd, 4 * H, generator=g)
    wh = (0.2 * torch.rand(nd, H, 4 * H, generator=g) - 0.1
          ).to(torch.bfloat16)
    lens = _lens_case(T, B, g)
    start = torch.stack([torch.zeros_like(lens), T - lens])[:nd]
    end = torch.stack([lens, torch.full_like(lens, T)])[:nd]
    args = [t.to(dev).contiguous() for t in (xproj, b, wh, start, end)]
    n0 = lstm_cuda.lstm_fwd.launches
    got = lstm_cuda.lstm_seq(*args)
    want = lstm_cuda.lstm_seq_plain(*args).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fwd.launches == n0 + 1
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


def test_lstm_kernels_no_steps_and_no_rows(dev):
    """T = 0 and B = 0 have no block to launch: empty outputs on the
    card and no launch counted."""
    for T, B in ((0, 3), (5, 0)):
        xproj, b, wh, start, end, gout = _lstm_case_lens(dev, 2, T, B, 32)
        n2, n3 = lstm_cuda.lstm_fwd.launches, lstm_cuda.lstm_bwd.launches
        h, c, gates = lstm_cuda.lstm_fwd(xproj, b, wh, start, end,
                                         residuals=True)
        dx, db = lstm_cuda.lstm_bwd(gout, gates, c, wh, start, end)
        assert h.is_cuda and h.shape == c.shape == (2, T, B, 32)
        assert gates.shape == dx.shape == (2, T, B, 128)
        assert db.shape == (2, 128) and not db.any()
        assert (lstm_cuda.lstm_fwd.launches, lstm_cuda.lstm_bwd.launches) \
            == (n2, n3)


def _lstm_case_lens(dev, nd, T, B, H):
    z = torch.zeros
    lens = z(B, dtype=torch.int32)
    return [t.to(dev) for t in (
        z(nd, T, B, 4 * H, dtype=torch.bfloat16), z(nd, 4 * H),
        z(nd, H, 4 * H, dtype=torch.bfloat16), torch.stack([lens, T - lens]),
        torch.stack([lens, lens + T]), z(nd, T, B, H, dtype=torch.bfloat16))]


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
    n0 = lstm_cuda.lstm_fwd.launches
    with torch.inference_mode():
        lk, lens_k = apply_encoder(params, feats, flens, cfg)
        lp, lens_p = apply_encoder(
            params, feats, flens,
            dataclasses.replace(cfg, use_pallas_rnn=False))
    assert lstm_cuda.lstm_fwd.launches == n0 + 2
    assert torch.equal(lens_k, lens_p)
    # kernel path: bf16 xproj / wh; plain path at f32 compute
    assert (lk - lp).abs().max().item() <= 2e-2


def _lstm_case(dev, nd, T, B, H, seed):
    g = torch.Generator().manual_seed(seed)
    xproj = torch.randn(nd, T, B, 4 * H, generator=g).to(torch.bfloat16)
    b = 0.1 * torch.randn(nd, 4 * H, generator=g)
    wh = (0.2 * torch.rand(nd, H, 4 * H, generator=g) - 0.1
          ).to(torch.bfloat16)
    lens = _lens_case(max(T, 1), B, g).clamp(max=T)
    start = torch.stack([torch.zeros_like(lens), T - lens])[:nd]
    end = torch.stack([lens, torch.full_like(lens, T)])[:nd]
    gout = torch.randn(nd, T, B, H, generator=g).to(torch.bfloat16)
    return [t.to(dev).contiguous() for t in (xproj, b, wh, start, end, gout)]


@pytest.mark.parametrize("nd,T,B,H", [(2, 2, 3, 48), (2, 3, 33, 96),
                                      (1, 1, 5, 64), (1, 12, 5, 64),
                                      (2, 30, 33, 96), (2, 7, 3, 48),
                                      (2, 9, 1, 16), (1, 20, 70, 16),
                                      (2, 40, 16, 800), (2, 30, 128, 800),
                                      (2, 60, 128, 512), (1, 25, 200, 512),
                                      (2, 60, 16, 512),
                                      # K3 in clusters of two: the train
                                      # cells' B=64, the ladder's B=32, an
                                      # odd width (2H no multiple of 128)
                                      (2, 40, 64, 800), (2, 33, 32, 800),
                                      (2, 40, 64, 512), (2, 30, 32, 400),
                                      (2, 3, 64, 800)])
def test_lstm_residuals_and_bptt_match_plain(dev, nd, T, B, H):
    """K2's residual mode and K3 against their plain versions on the same
    bf16 inputs (bf16 outputs: two ulps relative; db f32), with a
    length-1 and an empty row; dgates exactly 0 outside the windows."""
    _check_residuals_and_bptt(dev, nd, T, B, H)


@pytest.mark.parametrize("nd,B,H", [(2, 64, 800), (2, 64, 512),
                                    (2, 32, 800), (2, 128, 800)])
def test_lstm_bwd_runs_in_clusters_at_the_train_shapes(dev, nd, B, H):
    """At the train cells' shapes K3 is planned and launched in clusters
    of two blocks, and says so in its counters."""
    plan = lstm_cuda.plan_for(dev, nd, B, H, backward=True)
    assert plan.cluster == 2
    assert lstm_cuda.cluster_capacity(dev) >= plan.blocks // 2
    before = (lstm_cuda.lstm_bwd.launches,
              lstm_cuda.lstm_bwd.clustered_launches)
    _check_residuals_and_bptt(dev, nd, 5, B, H)
    assert (lstm_cuda.lstm_bwd.launches,
            lstm_cuda.lstm_bwd.clustered_launches) \
        == tuple(n + 1 for n in before)


@pytest.mark.parametrize("H,jt,bt", [(272, 32, 64), (272, 16, 64),
                                     (512, 32, 192)])
def test_lstm_bwd_clusters_on_any_tiling(dev, monkeypatch, H, jt, bt):
    """Clustered tilings the planner does not pick at these shapes: 32
    units with a ragged last tile (H = 272) and 16, each splitting a K of
    2H = 544 (a partial last chunk and atom); three passes of 64 rows, so
    the partner's partial tiles alternate between two buffers."""
    B = bt
    plan = lstm_cuda.RecurrencePlan(
        jt, bt, (-(-H // jt), 1, 2),
        lstm_cuda.recurrence_smem_bytes(H, jt, bt, 4, True, 2), cluster=2)
    assert plan.smem_bytes <= lstm_cuda.SMEM_PER_BLOCK
    planned = lstm_cuda.plan_for
    monkeypatch.setattr(
        lstm_cuda, "plan_for",
        lambda *a, **k: plan if k.get("backward") else planned(*a, **k))
    _check_residuals_and_bptt(dev, 2, 17, B, H)


@pytest.mark.parametrize("H", [272, 400, 496])
def test_lstm_persistent_unit_tile_of_32_at_odd_widths(dev, H):
    """H = 16 x an odd number at B = 128 plans 32 units a block, whose K3
    stacks the two halves of K = 4H as rows: 2H is then no multiple of
    the 64-column atom, and the last atom of the resident slice is
    partial (and the last unit tile ragged where H % 32 == 16)."""
    for backward in (False, True):
        assert lstm_cuda.plan_for(dev, 2, 128, H, backward=backward).jt == 32
    _check_residuals_and_bptt(dev, 2, 24, 128, H)


def _check_residuals_and_bptt(dev, nd, T, B, H):
    xproj, b, wh, start, end, gout = _lstm_case(dev, nd, T, B, H, T + H)
    n2, n3 = lstm_cuda.lstm_fwd.launches, lstm_cuda.lstm_bwd.launches
    h, c, gates = lstm_cuda.lstm_fwd(xproj, b, wh, start, end,
                                     residuals=True)
    ph, pc, pg = lstm_cuda.lstm_fwd_plain(xproj, b, wh, start, end)
    dx, db = lstm_cuda.lstm_bwd(gout, gates, c, wh, start, end)
    pdx, pdb = lstm_cuda.lstm_bwd_plain(gout, gates, c, wh, start, end)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_fwd.launches == n2 + 1
    assert lstm_cuda.lstm_bwd.launches == n3 + 1
    for got, want in ((h, ph), (c, pc), (gates, pg)):
        assert (got.float() - want).abs().max().item() <= LSTM_TOL
    scale = pdx.abs().max().item()
    assert (dx.float() - pdx).abs().max().item() <= 8e-3 * scale
    assert (db - pdb).abs().max().item() <= 1e-3 * pdb.abs().max().item()
    t = torch.arange(T, device=dev)[None, :, None]
    outside = (t < start[:, None]) | (t >= end[:, None])
    assert not dx.float().abs().amax(-1)[outside].any()


def test_lstmseq_autograd_on_card(dev):
    xproj, b, wh, start, end, gout = _lstm_case(dev, 2, 20, 6, 64, 0)
    x = xproj.clone().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    w = wh.clone().requires_grad_(True)
    n2, n3 = lstm_cuda.lstm_fwd.launches, lstm_cuda.lstm_bwd.launches
    h = lstm_cuda.LstmSeq.apply(x, bb, w, start, end)
    h.backward(gout)
    assert lstm_cuda.lstm_fwd.launches == n2 + 1
    assert lstm_cuda.lstm_bwd.launches == n3 + 1
    assert x.grad.dtype == torch.bfloat16 and bb.grad.dtype == torch.float32
    assert w.grad.dtype == torch.bfloat16
    assert torch.isfinite(x.grad.float()).all()
    # against the plain chain on the same bf16 values
    cx = xproj.cpu().requires_grad_(True)
    cb = b.cpu().requires_grad_(True)
    cw = wh.cpu().requires_grad_(True)
    lstm_cuda.LstmSeq.apply(cx, cb, cw, start.cpu(), end.cpu()).backward(
        gout.cpu())
    for got, want in ((x.grad, cx.grad), (bb.grad, cb.grad),
                      (w.grad, cw.grad)):
        scale = want.float().abs().max().item()
        assert (got.float().cpu() - want.float()).abs().max().item() \
            <= 2e-2 * scale
    with pytest.raises(RuntimeError, match="LstmSeq"):
        lstm_cuda.lstm_seq(x, bb, w, start, end)


@pytest.mark.parametrize("nd,T,B,H", [(2, 399, 128, 512), (2, 60, 128, 800),
                                      (1, 50, 37, 512), (2, 200, 64, 800),
                                      (2, 200, 64, 512)])
def test_lstm_persistent_kernels_repeat_bit_equal(dev, nd, T, B, H):
    """Two runs of the persistent K2 and K3 on one input give the same
    bits: no atomics in a sum, and no read of a buffer that another
    block has yet to write or has already overwritten."""
    xproj, b, wh, start, end, gout = _lstm_case(dev, nd, T, B, H, 3)
    runs = []
    for _ in range(3):
        h, c, gates = lstm_cuda.lstm_fwd(xproj, b, wh, start, end,
                                         residuals=True)
        dx, db = lstm_cuda.lstm_bwd(gout, gates, c, wh, start, end)
        runs.append((h, c, gates, dx, db))
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, o in zip(runs[0], other):
            assert torch.equal(a, o)


def test_lstm_cuda_tensor_never_reaches_plain(dev, monkeypatch):
    """On a CUDA tensor the wrappers launch kernels: the plain versions
    are not called, not even for an empty batch."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(lstm_cuda, "lstm_fwd_plain", refuse)
    monkeypatch.setattr(lstm_cuda, "lstm_bwd_plain", refuse)
    for T, B in ((4, 3), (0, 3), (4, 0)):
        xproj, b, wh, start, end, gout = _lstm_case(dev, 2, T, B, 32, 1)
        h, c, gates = lstm_cuda.lstm_fwd(xproj, b, wh, start, end,
                                         residuals=True)
        dx, _ = lstm_cuda.lstm_bwd(gout, gates, c, wh, start, end)
        assert h.is_cuda and dx.is_cuda
    torch.cuda.synchronize()


@pytest.mark.parametrize("gate_mult", [4, 3])
def test_width_without_a_plan_raises_before_any_launch(dev, gate_mult):
    """A width whose slices exceed the card's shared memory has no plan:
    the wrappers raise before anything is launched (the encoder gives
    such a layer its plain recurrence before it calls them)."""
    nd, T, B, H = 2, 3, 4, 1408
    assert lstm_cuda.plan_for(dev, nd, B, H, gate_mult) is None
    if gate_mult == 4:
        xproj, b, wh, start, end, _ = _lstm_case(dev, nd, T, B, H, 2)
        fn, seq = lstm_cuda.lstm_fwd, lstm_cuda.lstm_seq
    else:
        xproj, b, wh, start, end, _ = _gru_case(dev, nd, T, B, H, 2)
        fn, seq = gru_cuda.gru_fwd, gru_cuda.gru_seq
    n = fn.launches
    with pytest.raises(ValueError, match="no recurrence kernel fits"):
        seq(xproj, b, wh, start, end)
    assert fn.launches == n


def _gru_case(dev, nd, T, B, H, seed, lens=None):
    g = torch.Generator().manual_seed(seed)
    xproj = torch.randn(nd, T, B, 3 * H, generator=g).to(torch.bfloat16)
    b = 0.1 * torch.randn(nd, 3 * H, generator=g)
    wh = (0.2 * torch.rand(nd, H, 3 * H, generator=g) - 0.1
          ).to(torch.bfloat16)
    if lens is None:
        lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
        if B:
            lens[0] = T
    lens = torch.as_tensor(lens, dtype=torch.int32)
    start = torch.stack([torch.zeros_like(lens), T - lens])[:nd]
    end = torch.stack([lens, torch.full_like(lens, T)])[:nd]
    gout = torch.randn(nd, T, B, H, generator=g).to(torch.bfloat16)
    return [t.to(dev).contiguous() for t in (xproj, b, wh, start, end, gout)]


def _gate_err(got, want):
    """(r, z, n) lie in [-1, 1]; hn does not, so the error is taken
    relative to max(1, |want|)."""
    return ((got.float() - want).abs()
            / want.abs().clamp_min(1.0)).max().item()


def _outside(args, T, dev):
    t = torch.arange(T, device=dev)[None, :, None]
    return (t < args[3][:, None]) | (t >= args[4][:, None])


# T = 2 and 3 come first: a step barrier that deadlocks shows there
@pytest.mark.parametrize("nd,T,B,H,lens", [
    (2, 2, 3, 48, None), (2, 3, 33, 96, None),
    (1, 12, 5, 64, None), (2, 30, 33, 96, None), (2, 7, 3, 48, [7, 1, 0]),
    (1, 1, 5, 64, None), (2, 9, 1, 16, None), (1, 20, 70, 16, None),
    (2, 40, 128, 512, None), (2, 40, 16, 512, None), (2, 40, 16, 800, None),
    (2, 30, 128, 800, None), (2, 175, 1, 800, None), (1, 25, 200, 512, None)])
def test_gru_kernel_matches_plain(dev, nd, T, B, H, lens):
    """K4 in inference and residual mode against its plain version, with
    ragged rows, a length-1 and an empty row."""
    args = _gru_case(dev, nd, T, B, H, T + B, lens)[:5]
    n0 = gru_cuda.gru_fwd.launches
    got = gru_cuda.gru_seq(*args)
    h, gates = gru_cuda.gru_fwd(*args, residuals=True)
    ph, pg = gru_cuda.gru_fwd_plain(*args)
    torch.cuda.synchronize()
    assert gru_cuda.gru_fwd.launches == n0 + 2
    assert got.dtype == h.dtype == gates.dtype == torch.bfloat16
    assert torch.equal(got, h)
    assert (h.float() - ph).abs().max().item() <= LSTM_TOL
    assert _gate_err(gates, pg) <= LSTM_TOL
    assert not h.float().abs().amax(-1)[_outside(args, T, dev)].any()


@pytest.mark.parametrize("nd,T,B,H,lens", [
    (2, 2, 3, 48, None), (2, 3, 33, 96, None),
    (1, 12, 5, 64, None), (2, 30, 33, 96, None), (2, 7, 3, 48, [7, 1, 0]),
    (1, 1, 5, 64, None), (2, 9, 1, 16, None), (1, 20, 70, 16, None),
    (2, 40, 128, 512, None), (2, 40, 16, 512, None), (2, 40, 16, 800, None),
    (2, 30, 128, 800, None), (2, 60, 1, 800, None), (1, 25, 200, 512, None)])
def test_gru_bptt_matches_plain(dev, nd, T, B, H, lens):
    """K5 against its plain version on the kernel's own bf16 residuals
    (bf16 dxproj: two ulps relative to the largest), its f32 db against
    the f64 BPTT (no further than the plain version's), and dgates
    exactly 0 outside each row's window."""
    _check_gru_bptt(dev, nd, T, B, H, lens)


@pytest.mark.parametrize("H", [272, 400, 496])
def test_gru_persistent_unit_tile_of_32_at_odd_widths(dev, H):
    """H = 16 x an odd number at B = 128 plans 32 units a block: K5's
    K = 3H then halves into no whole k-step (3H/2 = 8 x odd), so its two
    stacked halves are rounded up to whole atoms; K4's last unit tile
    is ragged where H % 32 == 16."""
    for backward in (False, True):
        assert lstm_cuda.plan_for(dev, 2, 128, H, 3, backward).jt == 32
    args = _gru_case(dev, 2, 24, 128, H, H, [24, 1, 0] + [17] * 125)[:5]
    h, gates = gru_cuda.gru_fwd(*args, residuals=True)
    ph, pg = gru_cuda.gru_fwd_plain(*args)
    torch.cuda.synchronize()
    assert (h.float() - ph).abs().max().item() <= LSTM_TOL
    assert _gate_err(gates, pg) <= LSTM_TOL
    _check_gru_bptt(dev, 2, 24, 128, H, [24, 1, 0] + [17] * 125)


# K5's db against the f64 BPTT: no further from it than the plain version
# is, by this much of the largest f64 db. Both round dhproj to bf16 at
# every step; over 60 steps at H=800 and B=1 each lands 0.8e-3 to 1.2e-3
# from f64 and two summation orders of the plain version differ by up to
# 1.04e-3, so a kernel-vs-plain limit of 1e-3 there tests the rounding
# noise, not the kernel (chip_smoke.phase_gru_f64; PERF.md §6).
BPTT_F64_EXCESS = 5e-4


def _check_gru_bptt(dev, nd, T, B, H, lens):
    xproj, b, wh, start, end, gout = _gru_case(dev, nd, T, B, H, T + H, lens)
    h, gates = gru_cuda.gru_fwd(xproj, b, wh, start, end, residuals=True)
    n0 = gru_cuda.gru_bwd.launches
    dx, db = gru_cuda.gru_bwd(gout, gates, h, wh, start, end)
    pdx, pdb = gru_cuda.gru_bwd_plain(gout, gates, h, wh, start, end)
    _, xdb = gru_cuda.gru_bwd_plain(gout, gates, h, wh, start, end,
                                    exact=True)
    torch.cuda.synchronize()
    assert gru_cuda.gru_bwd.launches == n0 + 1
    assert dx.dtype == torch.bfloat16 and db.dtype == torch.float32
    scale = pdx.abs().max().item()
    assert (dx.float() - pdx).abs().max().item() <= 8e-3 * scale
    db_scale = xdb.abs().max().item()
    kernel_err = (db.double() - xdb).abs().max().item() / db_scale
    plain_err = (pdb.double() - xdb).abs().max().item() / db_scale
    assert kernel_err <= plain_err + BPTT_F64_EXCESS
    assert not dx.float().abs().amax(-1)[
        _outside((0, 0, 0, start, end), T, dev)].any()


@pytest.mark.parametrize("nd,T,B,H", [(2, 399, 128, 512), (2, 60, 128, 800),
                                      (2, 200, 16, 512)])
def test_gru_persistent_kernels_repeat_bit_equal(dev, nd, T, B, H):
    """Two runs of K4 and K5 on one input give the same bits: no atomics
    in a sum, and no read of an exchange buffer (h or dhproj) that
    another block has yet to write or has already overwritten."""
    xproj, b, wh, start, end, gout = _gru_case(dev, nd, T, B, H, 3)
    runs = []
    for _ in range(3):
        h, gates = gru_cuda.gru_fwd(xproj, b, wh, start, end, residuals=True)
        dx, db = gru_cuda.gru_bwd(gout, gates, h, wh, start, end)
        runs.append((h, gates, dx, db))
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, o in zip(runs[0], other):
            assert torch.equal(a, o)


def test_gru_cuda_tensor_never_reaches_plain(dev, monkeypatch):
    """On a CUDA tensor the GRU wrappers launch kernels: the plain
    versions are not called, not even for an empty batch."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(gru_cuda, "gru_fwd_plain", refuse)
    monkeypatch.setattr(gru_cuda, "gru_bwd_plain", refuse)
    for T, B in ((4, 3), (0, 3), (4, 0)):
        xproj, b, wh, start, end, gout = _gru_case(dev, 2, T, B, 32, 1,
                                                   lens=[min(T, 2)] * B)
        h, gates = gru_cuda.gru_fwd(xproj, b, wh, start, end, residuals=True)
        dx, _ = gru_cuda.gru_bwd(gout, gates, h, wh, start, end)
        assert h.is_cuda and dx.is_cuda
    torch.cuda.synchronize()


def test_gruseq_autograd_on_card(dev):
    xproj, b, wh, start, end, gout = _gru_case(dev, 2, 20, 6, 64, 0)
    x = xproj.clone().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    w = wh.clone().requires_grad_(True)
    h = gru_cuda.GruSeq.apply(x, bb, w, start, end)
    h.backward(gout)
    assert x.grad.dtype == torch.bfloat16 and bb.grad.dtype == torch.float32
    assert w.grad.dtype == torch.bfloat16
    # dwh against the plain chain on the same bf16 values
    cx = xproj.cpu().requires_grad_(True)
    cb = b.cpu().requires_grad_(True)
    cw = wh.cpu().requires_grad_(True)
    gru_cuda.GruSeq.apply(cx, cb, cw, start.cpu(), end.cpu()).backward(
        gout.cpu())
    scale = cw.grad.float().abs().max().item()
    assert (w.grad.float().cpu() - cw.grad.float()).abs().max().item() \
        <= 2e-2 * scale
    with pytest.raises(RuntimeError, match="GruSeq"):
        gru_cuda.gru_seq(x, bb, w, start, end)


def test_gru_kernels_no_steps_and_no_rows(dev):
    """T = 0 and B = 0 have no block to launch: empty outputs on the
    card, zero db, no launch counted, and no plain version on a CUDA
    tensor."""
    for T, B in ((0, 3), (5, 0)):
        xproj, b, wh, start, end, gout = _gru_case(dev, 2, T, B, 32, 1,
                                                   lens=[0] * B)
        n4, n5 = gru_cuda.gru_fwd.launches, gru_cuda.gru_bwd.launches
        h, gates = gru_cuda.gru_fwd(xproj, b, wh, start, end, residuals=True)
        dx, db = gru_cuda.gru_bwd(gout, gates, h, wh, start, end)
        assert h.is_cuda and h.shape == (2, T, B, 32)
        assert gates.shape == (2, T, B, 128) and dx.shape == (2, T, B, 96)
        assert db.shape == (2, 96) and not db.any()
        assert (gru_cuda.gru_fwd.launches, gru_cuda.gru_bwd.launches) \
            == (n4, n5)


def test_gru_kernels_reject_bad_input(dev):
    xproj, b, wh, start, end, gout = _gru_case(dev, 1, 4, 2, 32, 2)
    h, gates = gru_cuda.gru_fwd(xproj, b, wh, start, end, residuals=True)
    n4, n5 = gru_cuda.gru_fwd.launches, gru_cuda.gru_bwd.launches
    with pytest.raises(TypeError):                       # not bf16
        gru_cuda.gru_seq(xproj.float(), b, wh, start, end)
    with pytest.raises(ValueError, match="3\\*H"):       # 4H gates
        gru_cuda.gru_seq(torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16,
                                     device=dev), b, wh, start, end)
    with pytest.raises(ValueError, match="H % 16"):      # H = 24
        gru_cuda.gru_seq(
            torch.zeros(1, 4, 2, 72, dtype=torch.bfloat16, device=dev),
            torch.zeros(1, 72, device=dev),
            torch.zeros(1, 24, 72, dtype=torch.bfloat16, device=dev),
            start, end)
    with pytest.raises(ValueError, match="shape"):
        gru_cuda.gru_seq(xproj, b, wh[:, :16], start, end)
    with pytest.raises(ValueError, match="contiguous"):
        gru_cuda.gru_seq(xproj, b, wh.transpose(1, 2).contiguous()
                         .transpose(1, 2)[:, :, :96], start, end)
    odd = torch.zeros(wh.numel() + 1, dtype=torch.bfloat16, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):     # 2-byte offset
        gru_cuda.gru_seq(xproj, b, odd.view_as(wh), start, end)
    with pytest.raises(ValueError, match="4H"):
        gru_cuda.gru_bwd(gout, gates[..., :98].contiguous(), h, wh, start,
                         end)
    with pytest.raises(TypeError):
        gru_cuda.gru_bwd(gout.float(), gates, h, wh, start, end)
    assert (gru_cuda.gru_fwd.launches, gru_cuda.gru_bwd.launches) == (n4, n5)


def test_encoder_gru_kernel_path_matches_plain_path(dev):
    cfg = ModelConfig(frontend="conv", conv_channels=(8, 8), rnn_layers=2,
                      rnn_units=64, bidirectional=True, dropout=0.0,
                      compute_dtype="float32", rnn_type="gru")
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(rng.uniform(-0.1, 0.1, s)
                                  .astype(np.float32)).to(dev)
              for k, s in init_shapes(cfg, 40).items()}
    feats = torch.from_numpy(rng.standard_normal((4, 50, 40))
                             .astype(np.float32)).to(dev)
    flens = torch.tensor([50, 31, 7, 1], dtype=torch.int32, device=dev)
    n0, n2 = gru_cuda.gru_fwd.launches, lstm_cuda.lstm_fwd.launches
    with torch.inference_mode():
        lk, lens_k = apply_encoder(params, feats, flens, cfg)
        lp, lens_p = apply_encoder(
            params, feats, flens,
            dataclasses.replace(cfg, use_pallas_rnn=False))
    assert gru_cuda.gru_fwd.launches == n0 + 2
    assert lstm_cuda.lstm_fwd.launches == n2
    assert torch.equal(lens_k, lens_p)
    # kernel path: bf16 xproj / wh; plain path at f32 compute
    assert (lk - lp).abs().max().item() <= 2e-2


@pytest.mark.parametrize("B,T,U,C", [
    (5, 30, 6, 29), (37, 50, 20, 29), (3, 8, 2, 6),
    (4, 1, 2, 29), (4, 2, 3, 29),                      # T = 1, 2
    # T = 3..12 spans both kernels' rings (csrc/ctc.cu prefetches 8 rows
    # ahead into 10 slots): fewer rows than the prefetch, exactly it, and
    # past one turn of the ring
    *[(6, T, 3 if T <= 8 else 4, 29) for T in range(3, 13)],
    (16, 175, 40, 29),                                 # cli train's batch
])
def test_ctc_kernels_match_plain(dev, B, T, U, C):
    g = torch.Generator().manual_seed(B * T)
    logits = torch.randn(B, T, C, generator=g)
    labels = torch.randint(0, C - 1, (B, U), generator=g)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, dtype=torch.int32)
    llens = torch.randint(0, U + 1, (B,), generator=g, dtype=torch.int32)
    llens[0], lens[-1], llens[-1] = 0, 1, U             # empty; infeasible
    lp = torch.log_softmax(logits, -1)
    z = ctc_cuda.extended_labels(labels, C - 1)
    lpz = torch.gather(lp, 2, z[:, None, :].expand(-1, T, -1)) \
        .transpose(0, 1).contiguous().to(dev)
    skip = ctc_cuda.can_skip(z, C - 1).to(dev)
    lens, ends = lens.to(dev), (2 * llens).int().to(dev)
    alphas, nll = ctc_cuda.ctc_alpha(lpz, skip, lens, ends)
    grad = ctc_cuda.ctc_beta_grad(lpz, alphas, skip, lens, ends, nll)
    palphas, pnll = ctc_cuda.ctc_alpha_plain(lpz, skip, lens, ends)
    pgrad = ctc_cuda.ctc_beta_grad_plain(lpz, palphas, skip, lens, ends,
                                         pnll)
    torch.cuda.synchronize()
    feas = pnll < 1e29
    assert not feas[-1] and nll[-1].item() >= 1e29
    # K6 does the plain version's operations in its order: equal bits
    assert torch.equal(alphas, palphas)
    rel = (nll - pnll).abs() / pnll.abs().clamp_min(1.0)
    assert rel[feas].max().item() <= CTC_TOL
    assert torch.isfinite(grad).all()
    assert (grad - pgrad)[:, feas].abs().max().item() <= CTC_TOL


def test_ctc_kernels_state_limit(dev):
    """S = 1023, the most a block of 1024 threads takes (K6's ring ~48
    KB), runs and matches the plain version; S = 1025 is refused before
    any launch."""
    g = torch.Generator().manual_seed(11)
    T, B = 12, 2

    def inputs(S):
        lpz = torch.log_softmax(torch.randn(T, B, S, generator=g), -1)
        skip = (torch.arange(S) % 2 == 1).float().expand(B, S).contiguous()
        lens = torch.full((B,), T, dtype=torch.int32)
        ends = torch.tensor([S - 1, 8], dtype=torch.int32)   # row 0 infeasible
        return [x.to(dev) for x in (lpz, skip, lens, ends)]

    def launches():
        return ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta_grad.launches

    n6, n7 = launches()
    lpz, skip, lens, ends = inputs(1025)
    with pytest.raises(ValueError, match="at most 1024"):
        ctc_cuda.ctc_alpha(lpz, skip, lens, ends)
    with pytest.raises(ValueError, match="at most 1024"):
        ctc_cuda.ctc_beta_grad(lpz, lpz, skip, lens, ends, lpz[0, :, 0])
    assert launches() == (n6, n7)
    lpz, skip, lens, ends = inputs(1023)
    alphas, nll = ctc_cuda.ctc_alpha(lpz, skip, lens, ends)
    grad = ctc_cuda.ctc_beta_grad(lpz, alphas, skip, lens, ends, nll)
    palphas, pnll = ctc_cuda.ctc_alpha_plain(lpz, skip, lens, ends)
    pgrad = ctc_cuda.ctc_beta_grad_plain(lpz, palphas, skip, lens, ends, pnll)
    torch.cuda.synchronize()
    assert launches() == (n6 + 1, n7 + 1)
    assert torch.equal(alphas, palphas)
    assert pnll[0].item() >= 1e29 and torch.equal(nll[0], pnll[0])
    assert abs(nll[1] - pnll[1]).item() <= CTC_TOL * abs(pnll[1].item())
    assert (grad - pgrad)[:, 1].abs().max().item() <= CTC_TOL


def _beam_case(dev, B, T, C, seed, table_rows=0):
    """Seeded logits (standard normal x 2), ragged lengths with one
    zero-length row, and optionally a random normalized LM table."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        (rng.standard_normal((B, T, C)) * 2).astype(np.float32)).to(dev)
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lens[0] = T
    if B > 1:
        lens[-1] = 0
    table = None
    if table_rows:
        table = torch.from_numpy(np.log(rng.dirichlet(
            np.ones(C - 1), size=table_rows)).astype(np.float32)).to(dev)
    return logits, torch.from_numpy(lens).to(dev), table


_BEAM_MODES = [
    dict(),                                                     # acoustic
    dict(n_ctx=28 ** 3, lm_weight=0.8, word_bonus=1.0),         # order 4
    dict(n_ctx=28 ** 4, lm_weight=0.8, word_bonus=1.0),         # order 5
    dict(n_ctx=28 ** 3, lm_weight=0.8, word_bonus=1.0, nbest=True),
]


@pytest.mark.parametrize("mode", range(len(_BEAM_MODES)))
@pytest.mark.parametrize("B,T,K", [(3, 20, 8), (128, 400, 64)])
def test_beam_kernel_matches_plain(dev, B, T, K, mode):
    """Held as ``chip_smoke.beam_agreement`` holds it: identical ids and
    lengths in every row whose two best final scores differ by more than
    1e-3, N-best scores within 1e-4 relative, no duplicate live prefix."""
    from chip_smoke import beam_agreement
    m = dict(_BEAM_MODES[mode])
    nbest = m.pop("nbest", False)
    logits, lens, table = _beam_case(dev, B, T, 29, B + mode,
                                     m.pop("n_ctx", 0))
    # U = T: prefixes cut at the decode buffer's end could coincide
    kw = dict(beam_width=K, lm_table=table, max_decode_len=T, **m)
    n0 = beam_cuda.beam_search_decode_cuda.launches
    got = beam_cuda.beam_search_decode_cuda(logits, lens, return_nbest=True,
                                            **kw)
    torch.cuda.synchronize()
    assert beam_cuda.beam_search_decode_cuda.launches == n0 + 1
    want = beam_cuda.beam_search_decode_plain(logits, lens,
                                              return_nbest=True, **kw)
    assert got[0].shape == want[0].shape == (B, K, T)
    assert got[0].dtype == torch.int32
    assert beam_agreement(got, want)["excused"] <= B // 16
    assert int(got[1][-1].max()) == 0                   # the empty row
    if not nbest:
        ids, dl = beam_cuda.beam_search_decode_cuda(logits, lens, **kw)
        assert torch.equal(ids, got[0][:, 0]) and torch.equal(dl, got[1][:, 0])


@pytest.mark.parametrize("name,N,K", SELECT_CASES)
def test_beam_selection_alone_matches_stable_sort(dev, name, N, K):
    """K8's top-K selection alone (one block, ``beam_select_probe``) on
    crafted keys: the K best keys and flat indices equal those of a
    stable descending ``torch.sort`` of ``ops.beam._sort_key``,
    exactly."""
    scores, h1 = (torch.from_numpy(a) for a in select_case(name, N, K))
    keys, flat = beam_cuda.select_top_k_probe(scores.to(dev), h1.to(dev), K)
    torch.cuda.synchronize()
    want_keys, want_flat = beam_cuda.select_top_k_probe(scores, h1, K)
    assert torch.equal(keys.cpu(), want_keys)
    assert torch.equal(flat.cpu(), want_flat)


@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("B,T,C,K", [(4, 40, 29, 64), (4, 24, 2, 512)])
def test_beam_kernel_exact_ties_identical(dev, B, T, C, K, lm):
    """Quantized logits tie many candidates exactly; with the LM, a flat
    table, a word bonus of 3 and logits that favour the space and the
    blank drive the fused scores positive. The kernel must give the
    plain version's ids, lengths and N-best scores in every row."""
    from chip_smoke import beam_agreement
    rng = np.random.default_rng(T * K + lm)
    x = np.round(rng.standard_normal((B, T, C)) * 2) / 2.0
    if lm:
        x[:, :, [0, C - 1]] += 3.0        # char 0 is the space
    logits = torch.from_numpy(x.astype(np.float32)).to(dev)
    lens = torch.tensor([T, T, T - 5, T // 2], dtype=torch.int32,
                        device=dev)
    kw = dict(beam_width=K, blank_id=C - 1, max_decode_len=T,
              return_nbest=True)
    if lm:
        kw.update(lm_table=torch.zeros(C - 1, C - 1, device=dev),
                  lm_weight=1.0, word_bonus=3.0, lm_vocab=C - 1)
    got = beam_cuda.beam_search_decode_cuda(logits, lens, **kw)
    want = beam_cuda.beam_search_decode_plain(logits, lens, **kw)
    torch.cuda.synchronize()
    assert beam_agreement(got, want)["excused"] == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if lm:
        assert want[2].max().item() > 0


@pytest.mark.parametrize("K", [8, 32, 64, 512])
def test_beam_kernel_two_classes(dev, K):
    """C = 2 with K >= 32 gives a block exactly K threads: every thread
    picks a beam, and the same threads must still fetch the next frame."""
    from chip_smoke import beam_agreement
    logits, lens, _ = _beam_case(dev, 4, 24, 2, K)
    kw = dict(beam_width=K, blank_id=1, max_decode_len=24, return_nbest=True)
    got = beam_cuda.beam_search_decode_cuda(logits, lens, **kw)
    want = beam_cuda.beam_search_decode_plain(logits, lens, **kw)
    torch.cuda.synchronize()
    assert beam_agreement(got, want)["excused"] == 0


@pytest.mark.parametrize("nbest", [False, True])
def test_beam_kernel_no_frames_and_no_rows(dev, nbest):
    """T = 0 launches the kernel (every row emits the empty prefix); a
    batch of no rows has no block to launch and gets empty outputs."""
    kw = dict(beam_width=4, return_nbest=nbest)
    lens = torch.zeros(3, dtype=torch.int32, device=dev)
    n0 = beam_cuda.beam_search_decode_cuda.launches
    got = beam_cuda.beam_search_decode_cuda(
        torch.zeros(3, 0, 29, device=dev), lens, **kw)
    torch.cuda.synchronize()
    assert beam_cuda.beam_search_decode_cuda.launches == n0 + 1
    want = beam_cuda.beam_search_decode_plain(torch.zeros(3, 0, 29),
                                              lens.cpu(), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu(), w)
    got = beam_cuda.beam_search_decode_cuda(
        torch.zeros(0, 5, 29, device=dev), lens[:0], **kw)
    assert beam_cuda.beam_search_decode_cuda.launches == n0 + 1
    want = beam_cuda.beam_search_decode_plain(torch.zeros(0, 5, 29),
                                              lens[:0].cpu(), **kw)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape and g.dtype == w.dtype


def test_beam_kernel_long_buffer_and_clamp(dev):
    """U beyond the reference kernel's 1024 lanes, and a clamp that
    drops characters."""
    n_chars, C = 1300, 29
    T = 2 * n_chars
    logits = torch.full((1, T, C), -10.0)
    text = [(i % 27) + 1 for i in range(n_chars)]
    logits[0, 2 * torch.arange(n_chars), torch.tensor(text)] = 10.0
    logits[0, 2 * torch.arange(n_chars) + 1, C - 1] = 10.0
    lens = torch.tensor([T], dtype=torch.int32)
    ids, dl = beam_cuda.beam_search_decode_cuda(
        logits.to(dev), lens.to(dev), beam_width=4, max_decode_len=2000)
    assert ids.shape == (1, 2000) and int(dl[0]) == n_chars
    assert ids[0, :n_chars].tolist() == text
    ids, dl = beam_cuda.beam_search_decode_cuda(
        logits.to(dev), lens.to(dev), beam_width=4)
    assert ids.shape == (1, 256) and int(dl[0]) == 256
    assert ids[0].tolist() == text[:256]


def test_beam_kernel_rejects_bad_input(dev):
    logits = torch.zeros(2, 5, 6, device=dev)
    lens = torch.tensor([5, 3], dtype=torch.int32, device=dev)
    n0 = beam_cuda.beam_search_decode_cuda.launches
    with pytest.raises(ValueError, match="blank"):
        beam_cuda.beam_search_decode_cuda(logits, lens, blank_id=2)
    with pytest.raises(ValueError, match="LM vocab"):
        beam_cuda.beam_search_decode_cuda(
            logits, lens, blank_id=5, lm_table=torch.zeros(7, 7, device=dev))
    with pytest.raises(ValueError, match="init_ctx"):
        beam_cuda.beam_search_decode_cuda(
            logits, lens, blank_id=5, lm_table=torch.zeros(5, 5, device=dev),
            init_ctx=9)
    with pytest.raises(ValueError, match="beam width"):
        beam_cuda.beam_search_decode_cuda(logits, lens, blank_id=5,
                                          beam_width=4096)
    assert beam_cuda.beam_search_decode_cuda.launches == n0


@contextlib.contextmanager
def _strict(monkeypatch):
    """``torch.use_deterministic_algorithms(True)``: raises at any op that
    has no deterministic implementation on the card (cuBLAS asks for
    ``CUBLAS_WORKSPACE_CONFIG``)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old)


def test_ctc_loss_backward_is_deterministic(dev, monkeypatch):
    """``ctc_loss``'s backward at the train step's B=128, T'=399, U=96
    (K6, K7 and ``LabelGather``) raises nothing under strict
    deterministic algorithms, and two calls give the same bits."""
    B, T, U, C = 128, 399, 96, 29
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(
        rng.standard_normal((B, T, C)).astype(np.float32)).to(dev)
    lens = torch.from_numpy(
        rng.integers(T // 2, T + 1, B).astype(np.int32)).to(dev)
    labels = torch.from_numpy(
        rng.integers(0, C - 1, (B, U)).astype(np.int32)).to(dev)
    llens = torch.from_numpy(
        rng.integers(U // 2, U + 1, B).astype(np.int32)).to(dev)

    def grad():
        x = logits.clone().requires_grad_(True)
        ctc_cuda.ctc_loss(x, lens, labels, llens).backward()
        return x.grad

    with _strict(monkeypatch):
        g1, g2 = grad(), grad()
    assert torch.isfinite(g1).all() and torch.equal(g1, g2)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_three_steps_from_one_seed_are_bit_equal(dev, rnn_type):
    """Three ``make_step_fn`` steps of ``conv_bilstm3`` at full width with
    dropout and SpecAugment on, from the seed's state, twice: the losses,
    the parameters and the Adam moments are bit-equal."""
    cfg = preset("conv_bilstm3")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, rnn_type=rnn_type),
        train=dataclasses.replace(cfg.train, specaugment=True))
    B, S, U = 16, 64000, 48
    rng = np.random.default_rng(5)
    batch = [torch.from_numpy(a).to(dev) for a in (
        (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
        rng.integers(S // 2, S + 1, B).astype(np.int32),
        rng.integers(0, 28, (B, U)).astype(np.int32),
        rng.integers(U // 2, U + 1, B).astype(np.int32))]
    runs = []
    for _ in range(2):
        st = train_mod.init_train_state(cfg, "cuda")
        step = train_mod.make_step_fn(cfg)
        losses = [step(st, *batch)["loss"] for _ in range(3)]
        runs.append((torch.stack(losses),
                     {k: v.detach() for k, v in st["params"].items()},
                     st["opt_state"]["mu"], st["opt_state"]["nu"]))
    (l1, *trees1), (l2, *trees2) = runs
    assert torch.isfinite(l1).all() and torch.equal(l1, l2)
    for a, b in zip(trees1, trees2):
        assert all(torch.equal(a[k], b[k]) for k in a)


def _att_case(dev, B, H, T, lens, seed):
    """q, k, v [B, H, T, 64] and p [H, 2T-1, 64] bf16 in the projections'
    layouts with the biases u, v [H, 64] f32 (in that order: q, u, v, k,
    v, p), the output's gradient and the lengths; a (lo, hi) pair of
    ``lens`` draws B lengths in that range."""
    if isinstance(lens, tuple):
        rng = np.random.default_rng(seed)
        lens = sorted(rng.integers(lens[0], lens[1] + 1, B).tolist(),
                      reverse=True)
    g = torch.Generator(device=dev).manual_seed(seed)

    def mk(*shape):
        return (0.5 * torch.randn(*shape, generator=g, device=dev)).to(
            torch.bfloat16)
    q, k, v, do = (mk(B, T, H, 64).transpose(1, 2) for _ in range(4))
    u, vb = (mk(H, 64).float() for _ in range(2))
    p = mk(2 * T - 1, H, 64).transpose(0, 1)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    key_pad = torch.arange(T, device=dev)[None, :] >= lens[:, None]
    return [q, u, vb, k, v, p], do, lens, key_pad


def _att_plain_f32(key_pad):
    """The plain core in f32 with the kernel's prologue: qu and qv rounded
    to bf16 as K9 rounds them, their gradients passed on in f32."""
    def fn(q, u, vb, k, v, p):
        qs = [x + (x.bfloat16().float() - x).detach()
              for x in conformer.rel_queries(q, u, vb)]
        return conformer.attention_core_plain(*qs, k, v, p, key_pad)
    return fn


def _att_grads(fn, xs, do):
    ys = [x.detach().clone().requires_grad_() for x in xs]
    o = fn(*ys)
    return [o.detach(), *torch.autograd.grad(o, ys, do.to(o.dtype))]


def _att_err(got, want) -> float:
    return ((got.float() - want).abs().max()
            / max(want.abs().max().item(), 1e-2)).item()


def _launches():
    return (attention_cuda.rel_attention.launches,
            attention_cuda.rel_attention_backward.launches)


@pytest.mark.parametrize("B,H,T,lens", [
    (64, 8, 216, (33, 213)),      # the Conformer cell's buckets
    (64, 8, 422, (389, 420)),
    (3, 8, 70, [70, 1, 33]),      # T' not a tile multiple; a row of 1
    (2, 8, 1, [1, 1]),            # T' = 1
    (4, 8, 128, [128] * 4),       # every row full
    (3, 2, 130, [0, 130, 64]),    # an empty row; lengths at tile edges
])
def test_rel_attention_matches_plain(dev, monkeypatch, B, H, T, lens):
    """K9's output and the six input gradients (q, the biases u and v, k,
    v, p) against the plain core in f32; two backward calls bit-equal;
    exact zeros at padded queries (output, dq) and padded keys (dk, dv);
    one launch of each direction a call, and no library attention."""
    xs, do, lens, key_pad = _att_case(dev, B, H, T, lens, seed=T)

    def refuse(*a, **k):
        raise AssertionError("the core called a library attention")
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        refuse)
    n0 = _launches()

    def fused(*ys):
        return conformer.attention_core(*ys, key_pad, lens)
    got = _att_grads(fused, xs, do)
    again = _att_grads(fused, xs, do)
    torch.cuda.synchronize()
    assert _launches() == (n0[0] + 2, n0[1] + 2)
    want = _att_grads(_att_plain_f32(key_pad), [x.float() for x in xs], do)
    for name, g_, w in zip(("o", "dq", "du", "dvb", "dk", "dv", "dp"), got,
                           want):
        assert _att_err(g_, w) <= ATT_TOL, (name, _att_err(g_, w))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for b, L in enumerate(lens.tolist()):
        for t in (got[0], got[1], got[4], got[5]):      # o, dq, dk, dv
            assert not t[b, :, L:].any()


def test_rel_attention_eval_runs_the_forward_alone(dev):
    xs, _, lens, key_pad = _att_case(dev, 2, 8, 40, [40, 17], seed=1)
    ys = [x.detach().clone().requires_grad_() for x in xs]
    n0 = _launches()
    c0 = profiling.counters().get(conformer.FUSED_COUNTER, 0)
    with torch.no_grad():
        o = conformer.attention_core(*ys, key_pad, lens)
    torch.cuda.synchronize()
    assert o.grad_fn is None and not o[1, :, 17:].any()
    assert _launches() == (n0[0] + 1, n0[1])
    assert profiling.counters()[conformer.FUSED_COUNTER] == c0 + 1


def test_rel_attention_dropout_takes_the_plain_core(dev):
    xs, do, lens, key_pad = _att_case(dev, 2, 8, 40, [40, 17], seed=2)
    n0 = _launches()
    c0 = profiling.counters()
    g = torch.Generator(device=dev).manual_seed(0)
    got = _att_grads(lambda *ys: conformer.attention_core(
        *ys, key_pad, lens, 0.1, g), xs, do)
    torch.cuda.synchronize()
    c1 = profiling.counters()
    assert _launches() == n0
    assert c1.get(conformer.FUSED_COUNTER, 0) == \
        c0.get(conformer.FUSED_COUNTER, 0)
    assert c1[conformer.CALLS_COUNTER] == \
        c0.get(conformer.CALLS_COUNTER, 0) + 1
    assert torch.isfinite(got[0]).all() and not got[0][1, :, 17:].any()
