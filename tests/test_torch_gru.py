"""The port's GRU and vanilla-RNN layers (ctc_asr_tpu_torch.ops.gru_cuda,
models.rnn) held against the JAX reference on the CPU.

- ``GruSeq`` (on the CPU: K4's plain version with bf16 residuals, then
  K5's plain version ``gru_bwd_plain`` and ``dwh_from_seq``) against
  ``jax.vjp`` of ``gru_seq_pallas`` in interpret mode and ``_gru_run_fwd``:
  h, the (r, z, n, hn) residual, dxproj, db and dwh. Both sides round
  the same bf16 residuals and dgates; only f32 sum orders differ, and a
  sum-order difference that straddles a bf16 rounding boundary shows as
  one bf16 ulp, so the bf16 outputs are held to rtol 1e-2 (two ulps of
  2**-8) with a small atol for values near 0, and the f32 db to 1e-3
  (tests/test_torch_lstm_grad.py's limits).
- The plain scan path (autograd through ``gru_seq_plain`` /
  ``vanilla_seq_plain`` at f32) against ``gru_apply`` / ``vanilla_apply``
  / ``birnn_apply`` and their ``jax.grad`` at the golden 2e-4.
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
from ctc_asr_tpu.models.rnn import rnn_apply as j_rnn
from ctc_asr_tpu.ops.lstm_pallas import _gru_run_fwd, gru_seq_pallas
from ctc_asr_tpu_torch.models import rnn as t_rnn
from ctc_asr_tpu_torch.ops import gru_cuda
from torch_threads import one_thread  # noqa: F401  (autouse)

BF16_RTOL, BF16_ATOL = 1e-2, 2e-3
DB_TOL = 1e-3
TOL = 2e-4
PALLAS_TOL = 2e-3
KERNEL_RTOL, KERNEL_ATOL = 4e-2, 1e-2


def _seq_inputs(nd, T, B, H, lens, seed):
    rng = np.random.default_rng(seed)
    xproj = rng.standard_normal((nd, T, B, 3 * H)).astype(np.float32)
    b = (rng.standard_normal((nd, 3 * H)) * 0.1).astype(np.float32)
    wh = rng.uniform(-0.3, 0.3, (nd, H, 3 * H)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    start = np.stack([np.zeros(B, np.int32), T - lens])[:nd]
    end = np.stack([lens, np.full(B, T, np.int32)])[:nd]
    g = rng.standard_normal((nd, T, B, H)).astype(np.float32)
    return xproj, b, wh, start, end, g


# T = 19 is longer than the Pallas kernels' time block for these shapes,
# so the BPTT's h[t-1] crosses a block boundary on the JAX side
SEQ_CASES = [(1, 9, 3, 8, [9, 1, 5]), (2, 9, 3, 8, [9, 1, 5]),
             (2, 12, 5, 16, [12, 3, 7, 12, 1]), (1, 19, 3, 8, [19, 1, 11]),
             (2, 19, 4, 16, [19, 1, 7, 18])]


@pytest.mark.parametrize("nd,T,B,H,lens", SEQ_CASES)
def test_gruseq_matches_pallas_vjp(nd, T, B, H, lens):
    xproj, b, wh, start, end, g = _seq_inputs(nd, T, B, H, lens, seed=T + nd)
    jx = jnp.asarray(xproj, jnp.bfloat16)
    jwh = jnp.asarray(wh, jnp.bfloat16)
    js, je = jnp.asarray(start[..., None]), jnp.asarray(end[..., None])
    h_want, vjp = jax.vjp(
        lambda x, bb, w: gru_seq_pallas(x, bb, w, js, je, True),
        jx, jnp.asarray(b), jwh)
    dx_want, db_want, dwh_want = vjp(jnp.asarray(g, jnp.bfloat16))
    _, gates_want = _gru_run_fwd(jx, jnp.asarray(b), jwh, js, je, True)

    tx = torch.from_numpy(xproj).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    twh = torch.from_numpy(wh).to(torch.bfloat16).requires_grad_(True)
    ts, te = torch.from_numpy(start), torch.from_numpy(end)
    h = gru_cuda.GruSeq.apply(tx, tb, twh, ts, te)
    h.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert h.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    assert tb.grad.dtype == torch.float32 and twh.grad.dtype == torch.bfloat16

    def close(got, want, rtol=BF16_RTOL, atol=BF16_ATOL):
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=rtol, atol=atol)

    h2, gates = gru_cuda.gru_fwd(tx.detach(), tb.detach(), twh.detach(),
                                 ts, te, residuals=True)
    assert gates.dtype == torch.bfloat16 and gates.shape == (nd, T, B, 4 * H)
    assert torch.equal(h2, h.detach())
    close(h, h_want)
    # the residual is written at every step, masked rows included
    close(gates, gates_want[:, :T])
    close(tx.grad, dx_want)
    close(tb.grad, db_want, DB_TOL, DB_TOL)
    close(twh.grad, dwh_want)
    # outputs and dgates are 0 outside each row's window
    outside = ((np.arange(T)[None, :, None] < start[:, None, :])
               | (np.arange(T)[None, :, None] >= end[:, None, :]))
    assert not h.detach().float().numpy()[outside].any()
    assert not tx.grad.float().numpy()[outside].any()


@pytest.mark.parametrize("nd", [1, 2])
def test_kernel_wrapper_matches_pallas_kernel(nd):
    """ops.gru_cuda.gru_seq (its CPU path) against gru_seq_pallas in
    interpret mode at the Pallas tests' 2e-3."""
    T, B, H = 9, 3, 8
    xproj, b, wh, start, end, _ = _seq_inputs(nd, T, B, H, [9, 1, 5], nd)
    want = np.asarray(gru_seq_pallas(
        jnp.asarray(xproj, jnp.bfloat16), jnp.asarray(b),
        jnp.asarray(wh, jnp.bfloat16), jnp.asarray(start[..., None]),
        jnp.asarray(end[..., None]), True).astype(jnp.float32))
    got = gru_cuda.gru_seq(
        torch.from_numpy(xproj).to(torch.bfloat16), torch.from_numpy(b),
        torch.from_numpy(wh).to(torch.bfloat16), torch.from_numpy(start),
        torch.from_numpy(end))
    assert got.dtype == torch.bfloat16 and got.shape == (nd, T, B, H)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)


def test_bwd_plain_takes_h_prev_from_the_masked_output():
    """A flipped backward-direction row (window [T - len, T)) and a
    length-0 row: the plain BPTT on residuals of the forward gives the
    gradient autograd gives through the f32 plain forward, within the
    bf16 residuals' rounding."""
    nd, T, B, H = 2, 10, 4, 8
    xproj, b, wh, start, end, g = _seq_inputs(nd, T, B, H, [10, 1, 0, 6], 3)
    ts, te = torch.from_numpy(start), torch.from_numpy(end)
    tx = torch.from_numpy(xproj).to(torch.bfloat16).float().requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    twh = torch.from_numpy(wh).to(torch.bfloat16)
    h, gates = gru_cuda.gru_fwd_plain(tx, tb, twh, ts, te)
    tg = torch.from_numpy(g).to(torch.bfloat16).float()
    (h * tg).sum().backward()
    dx, db = gru_cuda.gru_bwd_plain(tg, gates.detach().to(torch.bfloat16),
                                    h.detach().to(torch.bfloat16), twh,
                                    ts, te)
    np.testing.assert_allclose(dx.numpy(), tx.grad.numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    np.testing.assert_allclose(db.numpy(), tb.grad.numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    assert not dx[:, :, 2].any()                      # the empty row


def _params(rng, F, H, gates):
    lim = np.sqrt(6.0 / (F + gates * H))
    return {"wx": rng.uniform(-lim, lim, (F, gates * H)).astype(np.float32),
            "wh": rng.uniform(-lim, lim, (H, gates * H)).astype(np.float32),
            "b": (rng.standard_normal(gates * H) * 0.1).astype(np.float32)}


_GATES = {"gru": 3, "rnn": 1}


def _to_jax(p):
    return jax.tree.map(jnp.asarray, p)


def _to_torch(p):
    return jax.tree.map(torch.from_numpy, p)


CASES = [(7, 3, 5, 8, [7, 1, 4]), (10, 4, 6, 16, [1, 10, 3, 10])]


@pytest.mark.parametrize("rnn_type", ["gru", "rnn"])
@pytest.mark.parametrize("T,B,F,H,lens", CASES)
def test_uni_plain_matches_reference(T, B, F, H, lens, rnn_type):
    rng = np.random.default_rng(T)
    p = _params(rng, F, H, _GATES[rnn_type])
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    want = np.asarray(j_rnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                            rnn_type, jnp.float32))
    fn = {"gru": t_rnn.gru_apply, "rnn": t_rnn.vanilla_apply}[rnn_type]
    got = fn(_to_torch(p), torch.from_numpy(x), torch.from_numpy(lens),
             torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for b, n in enumerate(lens):
        assert not got[n:, b].any()


@pytest.mark.parametrize("rnn_type", ["gru", "rnn"])
@pytest.mark.parametrize("T,B,F,H,lens", CASES)
def test_bi_plain_matches_reference(T, B, F, H, lens, rnn_type):
    rng = np.random.default_rng(T + 1)
    gates = _GATES[rnn_type]
    p = {"fwd": _params(rng, F, H, gates), "bwd": _params(rng, F, H, gates)}
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    want = np.asarray(j_birnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                              rnn_type, jnp.float32))
    got = t_rnn.birnn_apply(_to_torch(p), torch.from_numpy(x),
                            torch.from_numpy(lens), torch.float32,
                            rnn_type=rnn_type).numpy()
    assert got.shape == (T, B, 2 * H)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for b, n in enumerate(lens):
        assert not got[n:, b].any()


def test_bi_kernel_path_matches_pallas_path():
    """birnn_apply(use_kernel=True, rnn_type="gru") against the
    reference's fused Pallas BiGRU path (use_pallas=True, interpret);
    the vanilla cell ignores ``use_kernel`` in both packages."""
    T, B, F, H = 8, 2, 5, 8
    rng = np.random.default_rng(5)
    lens = np.array([8, 3], np.int32)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    p = {"fwd": _params(rng, F, H, 3), "bwd": _params(rng, F, H, 3)}
    want = np.asarray(j_birnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                              "gru", jnp.float32, use_pallas=True,
                              interpret=True).astype(jnp.float32))
    got = t_rnn.birnn_apply(_to_torch(p), torch.from_numpy(x),
                            torch.from_numpy(lens), torch.float32,
                            use_kernel=True, rnn_type="gru")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=PALLAS_TOL,
                               atol=PALLAS_TOL)
    p = {"fwd": _params(rng, F, H, 1), "bwd": _params(rng, F, H, 1)}
    want = np.asarray(j_birnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                              "rnn", jnp.float32, use_pallas=True))
    got = t_rnn.birnn_apply(_to_torch(p), torch.from_numpy(x),
                            torch.from_numpy(lens), torch.float32,
                            use_kernel=True, rnn_type="rnn")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rnn_type", ["gru", "rnn"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_plain_bf16_matches_reference_scan(bidirectional, rnn_type):
    """At compute_dtype=bfloat16 the plain path keeps the input
    projection in f32 from bf16 operands, as the reference's
    preferred_element_type=float32 does; the golden 2e-4 holds."""
    T, B, F, H = 20, 3, 40, 16
    rng = np.random.default_rng(20)
    lens = np.array([20, 7, 13], np.int32)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    gates = _GATES[rnn_type]
    if bidirectional:
        p = {"fwd": _params(rng, F, H, gates),
             "bwd": _params(rng, F, H, gates)}
        want = j_birnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens),
                       rnn_type, jnp.bfloat16)
        got = t_rnn.birnn_apply(_to_torch(p), torch.from_numpy(x),
                                torch.from_numpy(lens), torch.bfloat16,
                                rnn_type=rnn_type)
    else:
        p = _params(rng, F, H, gates)
        want = j_rnn(_to_jax(p), jnp.asarray(x), jnp.asarray(lens), rnn_type,
                     jnp.bfloat16)
        got = t_rnn.rnn_apply(_to_torch(p), torch.from_numpy(x),
                              torch.from_numpy(lens), rnn_type,
                              torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _grads_jax(fn, p, x, w):
    def loss(pp, xx):
        return jnp.sum(fn(pp, xx) * w)
    gp, gx = jax.grad(loss, argnums=(0, 1))(_to_jax(p), jnp.asarray(x))
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


def _layer_fns(rnn_type, bidirectional, lens_np, use_kernel=False):
    jl, tl = jnp.asarray(lens_np), torch.from_numpy(lens_np)
    if bidirectional:
        return (lambda pp, xx: j_birnn(pp, xx, jl, rnn_type, jnp.float32),
                lambda pp, xx: t_rnn.birnn_apply(
                    pp, xx, tl, torch.float32, use_kernel=use_kernel,
                    rnn_type=rnn_type))
    return (lambda pp, xx: j_rnn(pp, xx, jl, rnn_type, jnp.float32),
            lambda pp, xx: t_rnn.rnn_apply(pp, xx, tl, rnn_type,
                                           torch.float32,
                                           use_kernel=use_kernel))


@pytest.mark.parametrize("rnn_type", ["gru", "rnn"])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("T,B,F,H,lens", [(7, 3, 5, 8, [7, 1, 4]),
                                          (10, 4, 6, 16, [1, 10, 3, 10])])
def test_plain_grads_match_scan(T, B, F, H, lens, bidirectional, rnn_type):
    rng = np.random.default_rng(T + bidirectional)
    gates, nd = _GATES[rnn_type], 2 if bidirectional else 1
    p = ({"fwd": _params(rng, F, H, gates), "bwd": _params(rng, F, H, gates)}
         if bidirectional else _params(rng, F, H, gates))
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    w = rng.standard_normal((T, B, nd * H)).astype(np.float32)
    jfn, tfn = _layer_fns(rnn_type, bidirectional, np.asarray(lens, np.int32))
    _compare(_grads_torch(tfn, p, x, w), _grads_jax(jfn, p, x, w), TOL, TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_kernel_path_grads_match_scan(bidirectional):
    T, B, F, H = 7, 2, 4, 8
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T, B, F)).astype(np.float32)
    p = ({"fwd": _params(rng, F, H, 3), "bwd": _params(rng, F, H, 3)}
         if bidirectional else _params(rng, F, H, 3))
    w = rng.standard_normal((T, B, (1 + bidirectional) * H)
                            ).astype(np.float32)
    jfn, tfn = _layer_fns("gru", bidirectional, np.array([7, 4], np.int32),
                          use_kernel=True)
    _compare(_grads_torch(tfn, p, x, w), _grads_jax(jfn, p, x, w),
             KERNEL_RTOL, KERNEL_ATOL)


def test_forward_only_entry_refuses_grad():
    xproj, b, wh, start, end, _ = _seq_inputs(1, 4, 2, 8, [4, 2], seed=0)
    tx = torch.from_numpy(xproj).to(torch.bfloat16).requires_grad_(True)
    args = (tx, torch.from_numpy(b), torch.from_numpy(wh).to(torch.bfloat16),
            torch.from_numpy(start), torch.from_numpy(end))
    with pytest.raises(RuntimeError, match="GruSeq"):
        gru_cuda.gru_seq(*args)
    with torch.no_grad():
        assert gru_cuda.gru_seq(*args).shape == (1, 4, 2, 8)


def test_unknown_rnn_type_raises():
    p = _to_torch(_params(np.random.default_rng(0), 4, 8, 1))
    with pytest.raises(ValueError, match="rnn_type"):
        t_rnn.rnn_apply(p, torch.zeros(3, 2, 4), torch.tensor([3, 2]), "elman")
