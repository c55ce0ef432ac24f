"""The port's (bi)LSTM (ctc_asr_tpu_torch.models.rnn, ops.lstm_cuda) held
against the JAX reference on the CPU.

Weights and inputs come from numpy seeds. The plain path at float32 is
held to ``lstm_apply`` / ``birnn_apply`` at 2e-4; the kernel wrapper's
CPU path (bf16 inputs, the kernel's arithmetic) to the Pallas sequence
kernel in interpret mode at the Pallas tests' 2e-3
(tests/test_lstm_pallas.py:29).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctc_asr_tpu.models.rnn import birnn_apply as j_birnn
from ctc_asr_tpu.models.rnn import lstm_apply as j_lstm
from ctc_asr_tpu.ops.lstm_pallas import lstm_seq_pallas
from ctc_asr_tpu_torch.models import rnn as t_rnn
from ctc_asr_tpu_torch.ops import lstm_cuda
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 2e-4
PALLAS_TOL = 2e-3


def _lstm_params(rng, F, H):
    lim = np.sqrt(6.0 / (F + 4 * H))
    b = np.zeros(4 * H, np.float32)
    b[H:2 * H] = 1.0
    b += rng.standard_normal(4 * H).astype(np.float32) * 0.1
    return {"wx": rng.uniform(-lim, lim, (F, 4 * H)).astype(np.float32),
            "wh": rng.uniform(-lim, lim, (H, 4 * H)).astype(np.float32),
            "b": b}


def _to_jax(p):
    return {k: (_to_jax(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in p.items()}


def _to_torch(p):
    return {k: (_to_torch(v) if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in p.items()}


CASES = [(7, 3, 5, 8, [7, 1, 4]), (10, 4, 6, 16, [1, 10, 3, 10])]


@pytest.mark.parametrize("T,B,F,H,lens", CASES)
def test_uni_plain_matches_reference(T, B, F, H, lens):
    rng = np.random.default_rng(T)
    p = _lstm_params(rng, F, H)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    want = np.asarray(j_lstm(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                             jnp.float32))
    got = t_rnn.lstm_apply(_to_torch(p), torch.from_numpy(x),
                           torch.from_numpy(lens), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for b, n in enumerate(lens):
        assert not got[n:, b].any()


@pytest.mark.parametrize("T,B,F,H,lens", CASES)
def test_bi_plain_matches_reference(T, B, F, H, lens):
    rng = np.random.default_rng(T + 1)
    p = {"fwd": _lstm_params(rng, F, H), "bwd": _lstm_params(rng, F, H)}
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    want = np.asarray(j_birnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                              "lstm", jnp.float32))
    got = t_rnn.birnn_apply(_to_torch(p), torch.from_numpy(x),
                            torch.from_numpy(lens), torch.float32).numpy()
    assert got.shape == (T, B, 2 * H)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for b, n in enumerate(lens):
        assert not got[n:, b].any()


@pytest.mark.parametrize("nd", [1, 2])
def test_kernel_wrapper_matches_pallas_kernel(nd):
    """ops.lstm_cuda.lstm_seq (its CPU path) against lstm_seq_pallas in
    interpret mode: same direction-major bf16 inputs and windows."""
    T, B, H = 9, 3, 8
    rng = np.random.default_rng(nd)
    xproj = rng.standard_normal((nd, T, B, 4 * H)).astype(np.float32)
    b = (rng.standard_normal((nd, 4 * H)) * 0.1).astype(np.float32)
    wh = rng.uniform(-0.3, 0.3, (nd, H, 4 * H)).astype(np.float32)
    lens = np.array([9, 1, 5], np.int32)
    start = np.stack([np.zeros(B, np.int32), T - lens])[:nd]
    end = np.stack([lens, np.full(B, T, np.int32)])[:nd]
    want = np.asarray(lstm_seq_pallas(
        jnp.asarray(xproj, jnp.bfloat16), jnp.asarray(b),
        jnp.asarray(wh, jnp.bfloat16), jnp.asarray(start[..., None]),
        jnp.asarray(end[..., None]), True).astype(jnp.float32))
    got = lstm_cuda.lstm_seq(
        torch.from_numpy(xproj).to(torch.bfloat16), torch.from_numpy(b),
        torch.from_numpy(wh).to(torch.bfloat16), torch.from_numpy(start),
        torch.from_numpy(end))
    assert got.dtype == torch.bfloat16 and got.shape == (nd, T, B, H)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)
    outside = ((np.arange(T)[None, :, None] < start[:, None, :])
               | (np.arange(T)[None, :, None] >= end[:, None, :]))
    assert not got.float().numpy()[outside].any()


def test_bi_kernel_path_matches_pallas_path():
    """birnn_apply(use_kernel=True) against the reference's fused Pallas
    BiLSTM path (use_pallas=True, interpret)."""
    T, B, F, H = 8, 2, 5, 8
    rng = np.random.default_rng(5)
    p = {"fwd": _lstm_params(rng, F, H), "bwd": _lstm_params(rng, F, H)}
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.array([8, 3], np.int32)
    want = np.asarray(j_birnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                              "lstm", jnp.float32, use_pallas=True,
                              interpret=True).astype(jnp.float32))
    got = t_rnn.birnn_apply(_to_torch(p), torch.from_numpy(x),
                            torch.from_numpy(lens), torch.float32,
                            use_kernel=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_plain_bf16_matches_reference_scan(bidirectional):
    """At compute_dtype=bfloat16 the plain path keeps the input
    projection in f32 from bf16 operands, as the reference's
    preferred_element_type=float32 does; the golden 2e-4 holds."""
    T, B, F, H = 20, 3, 40, 16
    rng = np.random.default_rng(20)
    lens = np.array([20, 7, 13], np.int32)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    if bidirectional:
        p = {"fwd": _lstm_params(rng, F, H), "bwd": _lstm_params(rng, F, H)}
        want = j_birnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens), "lstm",
                       jnp.bfloat16)
        got = t_rnn.birnn_apply(_to_torch(p), torch.from_numpy(x),
                                torch.from_numpy(lens), torch.bfloat16)
    else:
        p = _lstm_params(rng, F, H)
        want = j_lstm(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                      jnp.bfloat16)
        got = t_rnn.lstm_apply(_to_torch(p), torch.from_numpy(x),
                               torch.from_numpy(lens), torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru", "rnn"])
def test_no_frames_gives_empty_outputs(rnn_type):
    """T = 0 (an empty bucket): every cell's plain recurrence returns
    [0, B, 2H] instead of failing to stack nothing."""
    F, H, B = 5, 8, 2
    rng = np.random.default_rng(0)
    G = {"lstm": 4, "gru": 3, "rnn": 1}[rnn_type] * H
    layer = {"wx": rng.standard_normal((F, G)).astype(np.float32),
             "wh": rng.standard_normal((H, G)).astype(np.float32),
             "b": np.zeros(G, np.float32)}
    p = _to_torch({"fwd": layer, "bwd": layer})
    for use_kernel in (False, True):
        out = t_rnn.birnn_apply(p, torch.zeros(0, B, F),
                                torch.zeros(B, dtype=torch.int32),
                                torch.float32, use_kernel=use_kernel,
                                rnn_type=rnn_type)
        assert out.shape == (0, B, 2 * H)
