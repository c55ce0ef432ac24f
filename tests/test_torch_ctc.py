"""The port's CTC loss (ctc_asr_tpu_torch.ops.ctc_cuda) held against the
JAX reference on the CPU.

On the CPU ``ctc_nll(use_kernel=True)`` runs ``CtcNll`` with the plain
versions of K6/K7 (``ctc_alpha_plain`` forward, ``ctc_beta_grad_plain``
backward); ``use_kernel=False`` is autograd through the plain α DP.
Both are held to ``ctc_loss_ref`` (autodiff through the scan) and to
``ctc_loss_pallas`` in interpret mode over the cases of
tests/test_ctc_pallas.py, at that file's tolerances: NLL 1e-4 (f32
log-space sums in another order), gradient rtol 1e-3 / atol 1e-4.
``torch.nn.functional.ctc_loss`` is a third oracle, in this test only.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ctc_asr_tpu.ops import ctc_pallas
from ctc_asr_tpu.ops.ctc_pallas import ctc_loss_pallas
from ctc_asr_tpu.ops.ctc_ref import ctc_loss as j_ctc_loss
from ctc_asr_tpu.ops.ctc_ref import ctc_loss_ref
from ctc_asr_tpu_torch.ops import ctc_cuda
from torch_threads import one_thread  # noqa: F401  (autouse)

NLL_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# α rows against the Pallas α: the golden tolerance in f32 (both sides
# run the same log-sum-exp per state, in other libraries' expf / logf)
ALPHA_TOL = 2e-4


def _case(seed, B, T, C, U, full_lens=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    labels = rng.integers(0, C - 1, size=(B, U)).astype(np.int32)
    if full_lens:
        lens = np.full((B,), T, np.int32)
        llens = np.full((B,), U, np.int32)
    else:
        lens = rng.integers(max(1, T // 2), T + 1, B).astype(np.int32)
        llens = rng.integers(1, U + 1, B).astype(np.int32)
    return logits, lens, labels, llens


def _edge_case():
    rng = np.random.default_rng(4)
    C, T = 6, 10
    logits = rng.standard_normal((4, T, C)).astype(np.float32)
    labels = np.array([[1, 1, 1, 0],    # repeats (mandatory blanks)
                       [2, 3, 4, 1],    # distinct
                       [0, 0, 0, 0],    # label_len 0 (empty)
                       [1, 2, 1, 2]],   # alternating, U = len
                      np.int32)
    return logits, np.array([T, 5, T, 4], np.int32), labels, \
        np.array([3, 4, 0, 4], np.int32)


def _port_nll(args, use_kernel, weights=None):
    logits, lens, labels, llens = args
    x = torch.from_numpy(logits).requires_grad_(True)
    nll = ctc_cuda.ctc_nll(x, torch.from_numpy(lens),
                           torch.from_numpy(labels), torch.from_numpy(llens),
                           blank_id=logits.shape[-1] - 1,
                           use_kernel=use_kernel)
    w = torch.ones_like(nll) if weights is None else torch.from_numpy(weights)
    # infeasible rows (+inf) take no part in the gradient
    torch.where(torch.isfinite(nll), nll * w, torch.zeros_like(nll)).sum() \
        .backward()
    return nll.detach().numpy(), x.grad.numpy()


def _ref(fn, args, weights=None):
    logits, lens, labels, llens = args
    C = logits.shape[-1]
    w = jnp.ones(len(lens)) if weights is None else jnp.asarray(weights)

    def f(lg):
        nll = fn(lg, jnp.asarray(lens), jnp.asarray(labels),
                 jnp.asarray(llens), blank_id=C - 1)
        return jnp.sum(jnp.where(jnp.isfinite(nll), nll * w, 0.0)), nll

    (_, nll), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    return np.asarray(nll), np.asarray(g)


def _pallas(lg, lens, labels, llens, blank_id):
    return ctc_loss_pallas(lg, lens, labels, llens, blank_id=blank_id,
                           interpret=True)


CASES = [
    ("small", lambda: _case(0, 3, 12, 6, 4)),
    ("charset", lambda: _case(1, 8, 20, 29, 6)),
    ("odd_batch", lambda: _case(2, 5, 30, 29, 10)),   # B not a multiple of 8
    ("two_tiles", lambda: _case(3, 9, 16, 10, 3)),
    ("edges", _edge_case),                            # empty, repeats, U=T
    ("full_lens", lambda: _case(7, 4, 14, 29, 5, full_lens=True)),
]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name,make", CASES)
def test_nll_and_grad_match_reference(name, make, use_kernel):
    args = make()
    want_nll, want_g = _ref(ctc_loss_ref, args)
    nll, g = _port_nll(args, use_kernel)
    np.testing.assert_allclose(nll, want_nll, rtol=NLL_TOL, atol=NLL_TOL)
    np.testing.assert_allclose(g, want_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("name,make", CASES[:3] + CASES[4:5])
def test_kernel_path_matches_pallas_interpret(name, make):
    args = make()
    want_nll, want_g = _ref(_pallas, args)
    nll, g = _port_nll(args, use_kernel=True)
    np.testing.assert_allclose(nll, want_nll, rtol=NLL_TOL, atol=NLL_TOL)
    np.testing.assert_allclose(g, want_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_matches_torch_ctc_loss():
    """F.ctc_loss(reduction="none", blank=C-1) as a third oracle."""
    logits, lens, labels, llens = _case(1, 8, 20, 29, 6)
    nll, g = _port_nll((logits, lens, labels, llens), use_kernel=True)
    x = torch.from_numpy(logits).requires_grad_(True)
    lp = torch.log_softmax(x, -1).transpose(0, 1)
    want = F.ctc_loss(lp, torch.from_numpy(labels).long(),
                      torch.from_numpy(lens).long(),
                      torch.from_numpy(llens).long(), blank=28,
                      reduction="none", zero_infinity=False)
    want.sum().backward()
    np.testing.assert_allclose(nll, want.detach().numpy(), rtol=NLL_TOL,
                               atol=NLL_TOL)
    np.testing.assert_allclose(g, x.grad.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_infeasible_is_inf_with_zero_finite_grad(use_kernel):
    """U > T: +inf NLL; the masked row's gradient is exact zeros, no NaN."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 3, 5)).astype(np.float32)
    labels = np.array([[0, 1, 2, 3], [1, 1, 0, 0], [0, 1, 0, 0]], np.int32)
    args = (logits, np.array([3, 3, 3], np.int32), labels,
            np.array([4, 4, 1], np.int32))
    nll, g = _port_nll(args, use_kernel)
    assert np.isinf(nll[:2]).all() and np.isfinite(nll[2])
    assert np.isfinite(g).all()
    assert not g[:2].any() and g[2].any()
    want = np.asarray(_pallas(*[jnp.asarray(a) for a in args], blank_id=4))
    assert np.isinf(want[:2]).all()
    np.testing.assert_allclose(nll[2], want[2], rtol=NLL_TOL)


def test_weighted_cotangent_and_zero_weight():
    args = _case(8, 3, 10, 6, 3)
    w = np.array([0.5, 2.0, 0.0], np.float32)
    _, want_g = _ref(ctc_loss_ref, args, w)
    _, g = _port_nll(args, use_kernel=True, weights=w)
    np.testing.assert_allclose(g, want_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert not g[2].any()


def test_grad_zero_beyond_length():
    logits, _, labels, llens = _case(9, 2, 12, 6, 3, full_lens=True)
    _, g = _port_nll((logits, np.array([7, 12], np.int32), labels, llens),
                     use_kernel=True)
    assert not g[0, 7:].any() and g[0, :7].any()


@pytest.mark.parametrize("average", ["utterance", "label", "sum"])
def test_reductions_match_reference(average):
    """Batch reductions with one infeasible row masked to 0."""
    logits, lens, labels, llens = _case(2, 5, 30, 29, 10)
    lens[1], llens[1] = 3, 10                       # infeasible
    C = logits.shape[-1]
    want = float(j_ctc_loss(jnp.asarray(logits), jnp.asarray(lens),
                            jnp.asarray(labels), jnp.asarray(llens),
                            blank_id=C - 1, average=average))
    want_g = np.asarray(jax.grad(lambda lg: j_ctc_loss(
        lg, jnp.asarray(lens), jnp.asarray(labels), jnp.asarray(llens),
        blank_id=C - 1, average=average))(jnp.asarray(logits)))
    for use_kernel in (True, False):
        x = torch.from_numpy(logits).requires_grad_(True)
        got = ctc_cuda.ctc_loss(x, torch.from_numpy(lens),
                                torch.from_numpy(labels),
                                torch.from_numpy(llens), blank_id=C - 1,
                                use_kernel=use_kernel, average=average)
        got.backward()
        np.testing.assert_allclose(got.item(), want, rtol=NLL_TOL)
        np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        assert np.isfinite(x.grad.numpy()).all()
    with pytest.raises(ValueError, match="average"):
        ctc_cuda.ctc_loss(torch.from_numpy(logits), torch.from_numpy(lens),
                          torch.from_numpy(labels), torch.from_numpy(llens),
                          average="mean")


def test_dp_pieces_match_each_other():
    """K7's plain version equals autograd through K6's plain version."""
    logits, lens, labels, llens = _case(3, 9, 16, 10, 3)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    z = ctc_cuda.extended_labels(torch.from_numpy(labels).long(), 9)
    lpz = torch.gather(lp, 2, z[:, None, :].expand(-1, 16, -1)) \
        .transpose(0, 1).contiguous().requires_grad_(True)
    skip = ctc_cuda.can_skip(z, 9)
    lens_t = torch.from_numpy(lens)
    ends = (2 * torch.from_numpy(llens)).int()
    alphas, nll = ctc_cuda.ctc_alpha_plain(lpz, skip, lens_t, ends)
    nll.sum().backward()
    grad = ctc_cuda.ctc_beta_grad_plain(lpz.detach(), alphas.detach(), skip,
                                        lens_t, ends, nll.detach())
    np.testing.assert_allclose(grad.numpy(), lpz.grad.numpy(), rtol=1e-4,
                               atol=1e-5)


def _dp_inputs(seed, B, T, C, U):
    """lp_z [T, B, S], skip [B, S], lens, ends from seeded logits: rows
    shorter than T, row 0 an empty label, the last row infeasible (U
    distinct labels in one frame)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(0, C - 1, size=(B, U))
    labels[-1] = np.arange(U)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    llens = rng.integers(1, U + 1, B).astype(np.int32)
    lens[0], llens[0] = T, 0
    lens[-1], llens[-1] = 1, U
    z = ctc_cuda.extended_labels(torch.from_numpy(labels), C - 1)
    skip = ctc_cuda.can_skip(z, C - 1).numpy()
    lpz = np.take_along_axis(lp, z.numpy()[:, None, :], axis=2)
    return (np.ascontiguousarray(lpz.transpose(1, 0, 2)), skip, lens,
            (2 * llens).astype(np.int32))


# T = 1 to 21 spans the kernels' ring (csrc/ctc.cu prefetches 8 rows
# ahead into 10 slots): fewer rows than the prefetch, exactly it, and
# past one turn of the ring
@pytest.mark.parametrize("T", [1, 8, 9, 11, 21])
def test_alpha_rows_match_pallas_interpret(T):
    """K6's plain version: every α row and the nll against the Pallas
    α kernel's residual (cropped from its B / S padding)."""
    lpz, skip, lens, ends = _dp_inputs(T, 6, T, 7, 4)
    B, S = skip.shape
    want_nll, res = ctc_pallas._ctc_nll_fwd_impl(
        jnp.asarray(lpz), jnp.asarray(skip), jnp.asarray(lens),
        jnp.asarray(ends), interpret=True)
    want = np.asarray(res[1])[:, :B, :S]
    alphas, nll = ctc_cuda.ctc_alpha_plain(
        torch.from_numpy(lpz), torch.from_numpy(skip), torch.from_numpy(lens),
        torch.from_numpy(ends))
    alphas, nll, want_nll = alphas.numpy(), nll.numpy(), np.asarray(want_nll)
    assert alphas.shape == want.shape == (T, B, S)
    neg = np.float32(ctc_cuda.NEG_INF)
    reach = want > neg / 2
    np.testing.assert_array_equal(alphas[~reach], neg)
    np.testing.assert_allclose(alphas[reach], want[reach], rtol=ALPHA_TOL,
                               atol=ALPHA_TOL)
    feas = want_nll < 1e29
    assert not feas[-1] and feas[0]
    np.testing.assert_array_equal(nll[~feas], want_nll[~feas])
    np.testing.assert_allclose(nll[feas], want_nll[feas], rtol=ALPHA_TOL,
                               atol=ALPHA_TOL)
