"""The fused relative-position attention kernel (K9,
``csrc/rel_attention.cu``) on the CPU: which calls of
``models.conformer.attention_core`` take it, and a plain tiled emulation
of its forward and backward passes, with the kernel's index arithmetic
(the band of positions each (query tile, key tile) pair gathers, the
skewed column of each score in it, the ring of band rows, the partials
of p's gradient summed over groups of batch rows, and the prologue's
biases: dq of both products and the biases' gradients as partials per
(group, query tile)), held to the core's autograd in f32. The card tests
(``tests/test_torch_kernels.py``) hold the kernel itself to the plain
core."""

import math

import pytest
import torch

from ctc_asr_tpu_torch.models import conformer
from ctc_asr_tpu_torch.ops import attention_cuda
from ctc_asr_tpu_torch.utils import profiling
from torch_threads import one_thread  # noqa: F401  (autouse)

LOG2E = 1.0 / math.log(2.0)
TOL = 2e-5      # f32, sums in another order (online softmax, tiles)


def _inputs(B, H, T, dk, seed, dtype=torch.float32):
    """q, u, v (the biases, f32), k, v, p and the output's gradient."""
    g = torch.Generator().manual_seed(seed)

    def mk(*shape, dt=dtype):
        return (torch.randn(*shape, generator=g) * 0.5).to(dt)
    q, k, v, do = (mk(B, H, T, dk) for _ in range(4))
    u, vb = (mk(H, dk, dt=torch.float32) for _ in range(2))
    return q, u, vb, k, v, mk(H, 2 * T - 1, dk), do


def _rows(x, lo, n, hi):
    """Rows [lo, lo + n) of x's first dim, zero where a row is not in
    [0, hi) (the kernel's zero-filled copies)."""
    idx = torch.arange(lo, lo + n)
    ok = (idx >= 0) & (idx < hi)
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype)
    out[ok] = x[idx[ok]]
    return out


def _tile_scores(qu, qv, k, p, b, h, i0, j0, T, tb):
    """The kernel's scores of query tile i0 against key tile j0: qu K^T
    plus the band of 2 tb positions from row T - tb - i0 + j0 of p, read
    at column (tb - 1 - i) + j."""
    Q = _rows(qu[b, h], i0, tb, T)
    K = _rows(k[b, h], j0, tb, T)
    band = _rows(p[h], T - tb - i0 + j0, 2 * tb, 2 * T - 1)
    bd = _rows(qv[b, h], i0, tb, T) @ band.T
    i = torch.arange(tb)[:, None]
    j = torch.arange(tb)[None, :]
    return Q @ K.T + bd[i, tb - 1 - i + j], band


def _tiled_forward(qu, qv, k, v, p, lens, tb):
    B, H, T, dk = qu.shape
    o = torch.zeros_like(qu)
    lse = torch.full((B, H, T), math.inf)
    for b in range(B):
        L = min(max(int(lens[b]), 0), T)
        for h in range(H):
            for i0 in range(0, L, tb):
                m = torch.full((tb,), -math.inf)
                l = torch.zeros(tb)
                acc = torch.zeros(tb, dk)
                for j0 in range(0, L, tb):
                    s, _ = _tile_scores(qu, qv, k, p, b, h, i0, j0, T, tb)
                    real = (torch.arange(j0, j0 + tb) < L)[None, :]
                    s = torch.where(real, s * LOG2E, -math.inf)
                    mx = torch.maximum(m, s.max(1).values)
                    e = torch.exp2(s - mx[:, None])
                    c = torch.exp2(m - mx)
                    l = l * c + e.sum(1)
                    acc = acc * c[:, None] + e @ _rows(v[b, h], j0, tb, L)
                    m = mx
                n = min(tb, L - i0)
                o[b, h, i0:i0 + n] = (acc / l[:, None])[:n]
                lse[b, h, i0:i0 + n] = (m + torch.log2(l))[:n]
    return o, lse


def _tile_ds(qu, qv, k, v, p, do, lse, delta, b, h, i0, j0, L, T, tb):
    """P and dS of a tile pair as the backward kernels recompute them."""
    s, band = _tile_scores(qu, qv, k, p, b, h, i0, j0, T, tb)
    real = (torch.arange(j0, j0 + tb) < L)[None, :] \
        & (torch.arange(i0, i0 + tb) < L)[:, None]
    lrow = _rows(lse[b, h], i0, tb, L)[:, None]
    P = torch.where(real, torch.exp2(s * LOG2E - lrow), 0.0)
    dP = _rows(do[b, h], i0, tb, L) @ _rows(v[b, h], j0, tb, L).T
    return P, P * (dP - _rows(delta[b, h], i0, tb, L)[:, None]), band


def _tiled_backward(qu, qv, k, v, p, lens, o, lse, do, tb, group):
    B, H, T, width = qu.shape
    nq = -(-T // tb)
    lens = [min(max(int(n), 0), T) for n in lens]
    delta = torch.stack([(do[b] * o[b]).sum(-1) * (torch.arange(T)
                                                   < lens[b]) for b in
                         range(B)])
    dqu, dqv, dk, dv = (torch.zeros_like(qu) for _ in range(4))
    # NaN where no partial was written: a read of one shows in dp
    part = torch.full((-(-B // group), H, nq, (nq + 1) * tb, width),
                      math.nan)
    i = torch.arange(tb)[:, None]
    j = torch.arange(tb)[None, :]

    def flush(ring, rows, dst, m0, ext):
        for c in range(tb):
            x = ring[rows[c]].clone()
            if m0 + c < ext:
                x += dst[m0 + c]
            dst[m0 + c] = x
            ring[rows[c]] = 0.0

    for g in range(-(-B // group)):                 # rel_attn_bwd_q
        for h in range(H):
            for qt in range(nq):
                i0 = qt * tb
                ring = torch.zeros(2 * tb, width)
                ext = 0
                for b in range(g * group, min(B, (g + 1) * group)):
                    L = lens[b]
                    if i0 >= L:
                        continue
                    nk = -(-L // tb)
                    Qv = _rows(qv[b, h], i0, tb, T)
                    for kt in range(nk):
                        j0 = kt * tb
                        _, dS, band = _tile_ds(qu, qv, k, v, p, do, lse,
                                               delta, b, h, i0, j0, L, T, tb)
                        n = min(tb, L - i0)
                        dqu[b, h, i0:i0 + n] += (dS @ _rows(k[b, h], j0, tb,
                                                            L))[:n]
                        skew = torch.zeros(tb, 2 * tb)
                        skew[i.expand(tb, tb), tb - 1 - i + j] = dS
                        dqv[b, h, i0:i0 + n] += (skew @ band)[:n]
                        ring[(torch.arange(2 * tb) + tb * kt) % (2 * tb)] \
                            += skew.T @ Qv
                        flush(ring, [(tb * kt + c) % (2 * tb)
                                     for c in range(tb)],
                              part[g, h, qt], tb * kt, ext)
                    flush(ring, [(tb * nk + c) % (2 * tb) for c in range(tb)],
                          part[g, h, qt], tb * nk, ext)
                    ext = max(ext, tb * (nk + 1))
    for b in range(B):                              # rel_attn_bwd_kv
        L = lens[b]
        for h in range(H):
            for j0 in range(0, L, tb):
                n = min(tb, L - j0)
                for i0 in range(0, L, tb):
                    P, dS, _ = _tile_ds(qu, qv, k, v, p, do, lse, delta, b,
                                        h, i0, j0, L, T, tb)
                    dv[b, h, j0:j0 + n] += (P.T @ _rows(do[b, h], i0, tb,
                                                        L))[:n]
                    dk[b, h, j0:j0 + n] += (dS.T @ _rows(qu[b, h], i0, tb,
                                                         T))[:n]
    dp = torch.zeros_like(p)                        # rel_attn_dp_reduce
    for h in range(H):
        for r in range(2 * T - 1):
            for g in range(-(-B // group)):
                n = max(-(-L // tb) for L in lens[g * group:(g + 1) * group])
                for qt in range(n):
                    m = r - T + tb + qt * tb
                    if 0 <= m < (n + 1) * tb:
                        dp[h, r] += part[g, h, qt, m]
    return dqu, dqv, dk, dv, dp


def _bias_grads(dqu, dqv, tb, group):
    """The backward's epilogue: dq = (dqu + dqv) / sqrt(d_k), and the
    biases' gradients as the partials per (group of batch rows, query
    tile) that ``rel_attn_bwd_q`` writes, summed."""
    B, H, T, width = dqu.shape
    scale = 1.0 / math.sqrt(width)
    nq = -(-T // tb)
    part = torch.zeros((-(-B // group), nq, 2, H, width))
    for g in range(-(-B // group)):
        for qt in range(nq):
            rows = slice(qt * tb, (qt + 1) * tb)
            for b in range(g * group, min(B, (g + 1) * group)):
                part[g, qt, 0] += dqu[b, :, rows].sum(1)
                part[g, qt, 1] += dqv[b, :, rows].sum(1)
            part[g, qt] *= scale
    du, dvb = part.sum((0, 1))
    return (dqu + dqv) * scale, du, dvb


def _plain(q, u, vb, k, v, p, lens, do):
    xs = [t.clone().requires_grad_() for t in (q, u, vb, k, v, p)]
    T = q.shape[2]
    lens = torch.tensor(lens, dtype=torch.int32)
    key_pad = torch.arange(T)[None, :] >= lens[:, None]
    o = conformer.attention_core(*xs, key_pad, lens)
    o.backward(do)
    return o.detach(), [x.grad for x in xs]


@pytest.mark.parametrize("tb,T,lens,group", [
    (4, 1, [1, 1], 2),              # T' = 1: one key, one position
    (4, 9, [9, 1, 5], 2),           # a row of length 1; T' not a tile
    (8, 20, [20, 13, 0, 7, 20], 4),  # an empty row; a group of one row
    (16, 37, [37, 16, 17, 1], 4),   # lengths at and past tile edges
    (8, 16, [16, 16], 4),           # every row full, T' a tile multiple
])
def test_tiled_emulation_matches_attention_core(tb, T, lens, group):
    B, H, dk = len(lens), 2, 8
    q, u, vb, k, v, p, do = _inputs(B, H, T, dk, seed=T + tb)
    o_ref, grads_ref = _plain(q, u, vb, k, v, p, lens, do)
    qu, qv = conformer.rel_queries(q, u, vb)
    o, lse = _tiled_forward(qu, qv, k, v, p, lens, tb)
    assert torch.allclose(o, o_ref, atol=TOL, rtol=0)
    dqu, dqv, dk_, dv, dp = _tiled_backward(qu, qv, k, v, p, lens, o, lse,
                                            do, tb, group)
    grads = (*_bias_grads(dqu, dqv, tb, group), dk_, dv, dp)
    for name, got, want in zip(("dq", "du", "dvb", "dk", "dv", "dp"), grads,
                               grads_ref):
        assert torch.isfinite(got).all(), name
        assert torch.allclose(got, want, atol=TOL, rtol=0), \
            (name, float((got - want).abs().max()))
    for b, L in enumerate(lens):    # padding: exact zeros, no gradient
        for t in (o, grads[0], dk_, dv):
            assert not t[b, :, L:].any()


@pytest.mark.parametrize("dtype,rate", [(torch.bfloat16, 0.0),
                                        (torch.float32, 0.0),
                                        (torch.bfloat16, 0.1)])
def test_cpu_tensors_take_the_plain_core(monkeypatch, dtype, rate):
    def refuse(*a, **k):
        raise AssertionError("the fused kernel's wrapper got a CPU tensor")
    monkeypatch.setattr(conformer, "rel_attention", refuse)
    B, H, T = 2, 2, 6
    q, u, vb, k, v, p, do = _inputs(B, H, T, attention_cuda.HEAD_DIM, 3,
                                    dtype)
    lens = torch.tensor([6, 4], dtype=torch.int32)
    key_pad = torch.arange(T)[None, :] >= lens[:, None]
    before = profiling.counters()
    o = conformer.attention_core(q, u, vb, k, v, p, key_pad, lens, rate,
                                 torch.Generator().manual_seed(0))
    after = profiling.counters()
    assert o.shape == (B, H, T, attention_cuda.HEAD_DIM)
    assert not o[1, :, 4:].any()
    assert after.get(conformer.CALLS_COUNTER, 0) == \
        before.get(conformer.CALLS_COUNTER, 0) + 1
    assert after.get(conformer.FUSED_COUNTER, 0) == \
        before.get(conformer.FUSED_COUNTER, 0)
