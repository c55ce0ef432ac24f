"""Gradients of the port's (bi)LSTM held against the JAX reference on the
CPU.

- ``LstmSeq`` (on the CPU: K2's plain version with bf16 residuals, then
  K3's plain version ``lstm_bwd_plain`` and ``dwh_from_seq``) against
  ``jax.vjp`` of ``lstm_seq_pallas`` in interpret mode: the saved c and
  gates, dxproj, db and dwh. Both sides round the same bf16 residuals
  and dgates; only f32 sum orders differ, and a sum-order difference
  that straddles a bf16 rounding boundary shows as one bf16 ulp, so the
  bf16 outputs are held to rtol 1e-2 (two ulps of 2**-8) with a small
  atol for values near 0, and the f32 db to 1e-3.
- The plain scan path (autograd through ``lstm_seq_plain`` at f32)
  against ``jax.grad`` of ``lstm_apply`` / ``birnn_apply`` at the golden
  2e-4.
- The kernel-arithmetic path (``use_kernel=True``: bf16 xproj/wh/
  residuals) against the scan path at tests/test_lstm_pallas.py's rtol
  4e-2 / atol 1e-2 (bf16 rounding compounds through the BPTT chain).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_asr_tpu.models.rnn import birnn_apply as j_birnn
from ctc_asr_tpu.models.rnn import lstm_apply as j_lstm
from ctc_asr_tpu.ops.lstm_pallas import _run_fwd, lstm_seq_pallas
from ctc_asr_tpu_torch.models import rnn as t_rnn
from ctc_asr_tpu_torch.ops import lstm_cuda
from torch_threads import one_thread  # noqa: F401  (autouse)

BF16_RTOL, BF16_ATOL = 1e-2, 2e-3
DB_TOL = 1e-3
TOL = 2e-4
KERNEL_RTOL, KERNEL_ATOL = 4e-2, 1e-2


def _seq_inputs(nd, T, B, H, lens, seed):
    rng = np.random.default_rng(seed)
    xproj = rng.standard_normal((nd, T, B, 4 * H)).astype(np.float32)
    b = (rng.standard_normal((nd, 4 * H)) * 0.1).astype(np.float32)
    wh = rng.uniform(-0.3, 0.3, (nd, H, 4 * H)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    start = np.stack([np.zeros(B, np.int32), T - lens])[:nd]
    end = np.stack([lens, np.full(B, T, np.int32)])[:nd]
    g = rng.standard_normal((nd, T, B, H)).astype(np.float32)
    return xproj, b, wh, start, end, g


SEQ_CASES = [(1, 9, 3, 8, [9, 1, 5]), (2, 9, 3, 8, [9, 1, 5]),
             (2, 12, 5, 16, [12, 3, 7, 12, 1])]


@pytest.mark.parametrize("nd,T,B,H,lens", SEQ_CASES)
def test_lstmseq_matches_pallas_vjp(nd, T, B, H, lens):
    xproj, b, wh, start, end, g = _seq_inputs(nd, T, B, H, lens, seed=T + nd)
    jx = jnp.asarray(xproj, jnp.bfloat16)
    jwh = jnp.asarray(wh, jnp.bfloat16)
    js, je = jnp.asarray(start[..., None]), jnp.asarray(end[..., None])
    h_want, vjp = jax.vjp(
        lambda x, bb, w: lstm_seq_pallas(x, bb, w, js, je, True),
        jx, jnp.asarray(b), jwh)
    dx_want, db_want, dwh_want = vjp(jnp.asarray(g, jnp.bfloat16))
    _, c_want, gates_want = _run_fwd(jx, jnp.asarray(b), jwh, js, je, True)

    tx = torch.from_numpy(xproj).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    twh = torch.from_numpy(wh).to(torch.bfloat16).requires_grad_(True)
    ts, te = torch.from_numpy(start), torch.from_numpy(end)
    h = lstm_cuda.LstmSeq.apply(tx, tb, twh, ts, te)
    h.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert h.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    assert tb.grad.dtype == torch.float32 and twh.grad.dtype == torch.bfloat16

    def close(got, want, rtol=BF16_RTOL, atol=BF16_ATOL):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=atol)

    _, c, gates = lstm_cuda.lstm_fwd(tx.detach(), tb.detach(), twh.detach(),
                                     ts, te, residuals=True)
    close(h, h_want)
    close(c, c_want[:, :T])
    close(gates, gates_want[:, :T])
    close(tx.grad, dx_want)
    close(tb.grad, db_want, DB_TOL, DB_TOL)
    close(twh.grad, dwh_want)
    # dgates are 0 outside each row's window
    outside = ((np.arange(T)[None, :, None] < start[:, None, :])
               | (np.arange(T)[None, :, None] >= end[:, None, :]))
    assert not tx.grad.float().numpy()[outside].any()


def _lstm_params(rng, F, H):
    lim = np.sqrt(6.0 / (F + 4 * H))
    b = np.zeros(4 * H, np.float32)
    b[H:2 * H] = 1.0
    b += rng.standard_normal(4 * H).astype(np.float32) * 0.1
    return {"wx": rng.uniform(-lim, lim, (F, 4 * H)).astype(np.float32),
            "wh": rng.uniform(-lim, lim, (H, 4 * H)).astype(np.float32),
            "b": b}


def _grads_jax(fn, p, x, w):
    def loss(pp, xx):
        return jnp.sum(fn(pp, xx) * w)
    gp, gx = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return jax.tree.map(np.asarray, gp), np.asarray(gx)


def _grads_torch(fn, p, x, w):
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    (fn(tp, tx).float() * torch.from_numpy(w)).sum().backward()
    return jax.tree.map(lambda a: a.grad.numpy(), tp), tx.grad.numpy()


def _compare(got, want, rtol, atol):
    gp, gx = got
    wp, wx = want
    np.testing.assert_allclose(gx, wx, rtol=rtol, atol=atol)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(wp)[0],
                            jax.tree_util.tree_leaves(gp)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=str(path))


@pytest.mark.parametrize("T,B,F,H,lens", [(7, 3, 5, 8, [7, 1, 4]),
                                          (10, 4, 6, 16, [1, 10, 3, 10])])
def test_uni_plain_grads_match_scan(T, B, F, H, lens):
    rng = np.random.default_rng(T)
    p = _lstm_params(rng, F, H)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    w = rng.standard_normal((T, B, H)).astype(np.float32)
    lens_np = np.asarray(lens, np.int32)
    want = _grads_jax(lambda pp, xx: j_lstm(pp, xx, jnp.asarray(lens_np),
                                            jnp.float32), p, x, w)
    got = _grads_torch(lambda pp, xx: t_rnn.lstm_apply(
        pp, xx, torch.from_numpy(lens_np), torch.float32), p, x, w)
    _compare(got, want, TOL, TOL)


@pytest.mark.parametrize("T,B,F,H,lens", [(6, 2, 4, 8, [6, 4]),
                                          (9, 3, 5, 16, [9, 5, 1])])
def test_bi_plain_grads_match_scan(T, B, F, H, lens):
    rng = np.random.default_rng(T + 1)
    p = {"fwd": _lstm_params(rng, F, H), "bwd": _lstm_params(rng, F, H)}
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    w = rng.standard_normal((T, B, 2 * H)).astype(np.float32)
    lens_np = np.asarray(lens, np.int32)
    want = _grads_jax(lambda pp, xx: j_birnn(pp, xx, jnp.asarray(lens_np),
                                             "lstm", jnp.float32), p, x, w)
    got = _grads_torch(lambda pp, xx: t_rnn.birnn_apply(
        pp, xx, torch.from_numpy(lens_np), torch.float32), p, x, w)
    _compare(got, want, TOL, TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_kernel_path_grads_match_scan(bidirectional):
    T, B, F, H = 7, 2, 4, 8
    rng = np.random.default_rng(11)
    lens_np = np.array([7, 4], np.int32)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    if bidirectional:
        p = {"fwd": _lstm_params(rng, F, H), "bwd": _lstm_params(rng, F, H)}
        w = rng.standard_normal((T, B, 2 * H)).astype(np.float32)
        jfn = lambda pp, xx: j_birnn(pp, xx, jnp.asarray(lens_np),  # noqa
                                     "lstm", jnp.float32)
        tfn = lambda pp, xx: t_rnn.birnn_apply(  # noqa: E731
            pp, xx, torch.from_numpy(lens_np), torch.float32,
            use_kernel=True)
    else:
        p = _lstm_params(rng, F, H)
        w = rng.standard_normal((T, B, H)).astype(np.float32)
        jfn = lambda pp, xx: j_lstm(pp, xx, jnp.asarray(lens_np),  # noqa
                                    jnp.float32)
        tfn = lambda pp, xx: t_rnn.lstm_apply(  # noqa: E731
            pp, xx, torch.from_numpy(lens_np), torch.float32,
            use_kernel=True)
    _compare(_grads_torch(tfn, p, x, w), _grads_jax(jfn, p, x, w),
             KERNEL_RTOL, KERNEL_ATOL)


def test_forward_only_entry_refuses_grad():
    xproj, b, wh, start, end, _ = _seq_inputs(1, 4, 2, 8, [4, 2], seed=0)
    tx = torch.from_numpy(xproj).to(torch.bfloat16).requires_grad_(True)
    args = (tx, torch.from_numpy(b), torch.from_numpy(wh).to(torch.bfloat16),
            torch.from_numpy(start), torch.from_numpy(end))
    with pytest.raises(RuntimeError, match="LstmSeq"):
        lstm_cuda.lstm_seq(*args)
    with torch.no_grad():
        assert lstm_cuda.lstm_seq(*args).shape == (1, 4, 2, 8)
