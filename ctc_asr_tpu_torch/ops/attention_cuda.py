"""Wrapper of the fused relative-position attention kernel
``csrc/rel_attention.cu`` (K9, forward and backward).

It replaces no TPU kernel: the JAX package has no Conformer. The plain
version is ``models.conformer.attention_core_plain`` (after
``rel_queries``), which CPU tensors and calls with dropout get; every
other call of ``attention_core`` comes here, and a dtype or head width
the kernel does not take raises. Contract: q, k, v ``[B, H, T, 64]`` and
p ``[H, 2T-1, 64]`` in bf16, the biases u, v ``[H, 64]`` f32 and the
rows' lengths ``[B]`` int32 -> o ``[B, H, T, 64]`` bf16, 0 at padded
queries. The forward's prologue forms qu = (q + u) / 8 and qv = (q + v) /
8 on chip (each f32 sum rounded once to bf16, as ``rel_queries``) and,
in a differentiable call, writes them out for the backward.

The kernels read every input by strides (d_k contiguous, rows 16-byte
aligned; anything else is copied to that layout first), so the
projections' ``[B, T, H, d_k]`` views need no copy, and they write o and
the gradients of q, k and v in that layout (returned as ``[B, H, T, d_k]``
views, so ``o.transpose(1, 2).reshape(B, T, d)`` is a view too) and p's
gradient in ``[2T-1, H, d_k]``. The backward's scratch, allocated here:
rowsum(dO o) ``[B, H, T]`` f32, the partials of p's gradient
``[ceil(B/GROUP), H, ceil(T/64), (ceil(T/64) + 1) * 64, d_k]`` f32, summed
by the third backward kernel in a fixed order, and those of the biases'
gradients ``[ceil(B/GROUP), ceil(T/64), 2, H, d_k]`` f32, summed here (no
atomics: a step repeats bit for bit).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .dispatch import require_kernel_device

HEAD_DIM = 64     # the kernels' d_k
TILE = 64         # query and key rows of a tile
# batch rows a backward block walks in order, summing their partials of
# p's gradient in its own slice (a quarter of the scratch of a slice a row)
GROUP = 4
SCALE = 1.0 / math.sqrt(HEAD_DIM)


def _checked(name: str, t: torch.Tensor, shape: tuple,
             dtype) -> torch.Tensor:
    """``t``, checked: a CUDA tensor of ``dtype`` and ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t


def _kernel_view(name: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``t`` checked (CUDA, bf16, ``shape``) in a layout the kernels read:
    the last dim contiguous, every other stride a multiple of 8 elements,
    the start 16-byte aligned; otherwise a contiguous copy."""
    t = _checked(name, t, shape, torch.bfloat16)
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _strides(views: list, bands: list):
    """A host int64 array of the (b, h, t) strides of each [B, H, T, d_k]
    view, then the (h, r) strides of each [H, 2T-1, d_k] band."""
    vals = [s for t in views for s in t.stride()[:3]] \
        + [s for t in bands for s in t.stride()[:2]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bthd(B: int, H: int, T: int, like: torch.Tensor) -> torch.Tensor:
    """A [B, H, T, d_k] bf16 view of a new [B, T, H, d_k] tensor."""
    return torch.empty((B, T, H, HEAD_DIM), dtype=torch.bfloat16,
                       device=like.device).transpose(1, 2)


def _forward(q, u, vb, k, v, p, lens, save: bool):
    """o and the log-sum-exp, and where ``save`` qu and qv (else None)."""
    B, H, T, _ = q.shape
    o = _bthd(B, H, T, q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    qu, qv = (_bthd(B, H, T, q), _bthd(B, H, T, q)) if save else (None, None)
    st = _strides([q, qu if save else q, qv if save else q, k, v, o], [p])
    rc = build.load().rel_attention_fwd(
        q.data_ptr(), u.data_ptr(), vb.data_ptr(), k.data_ptr(),
        v.data_ptr(), p.data_ptr(), lens.data_ptr(),
        qu.data_ptr() if save else None, qv.data_ptr() if save else None,
        o.data_ptr(), lse.data_ptr(), ctypes.addressof(st), B, H, T, SCALE,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "rel_attention_fwd")
    rel_attention.launches += 1
    return o, lse, qu, qv


def rel_attention_backward(qu, qv, k, v, p, lens, o, lse, do):
    """K9's backward: (dq, du, dv_bias, dk, dv, dp) of the forward's
    inputs from the output's gradient ``do`` and the forward's qu, qv;
    three launches (query tiles, key tiles, the sum of p's partials) and
    the sum of the biases' partials, counted once in ``.launches``."""
    B, H, T, dk = qu.shape
    do = _kernel_view("do", do, (B, H, T, dk))
    dq, dk_, dv = (_bthd(B, H, T, qu) for _ in range(3))
    dp = torch.empty((2 * T - 1, H, dk), dtype=torch.bfloat16,
                     device=qu.device).transpose(0, 1)
    n, groups = -(-T // TILE), -(-B // GROUP)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=qu.device)
    part = torch.empty((groups, H, n, (n + 1) * TILE, dk),
                       dtype=torch.float32, device=qu.device)
    duv = torch.empty((groups, n, 2, H, dk), dtype=torch.float32,
                      device=qu.device)
    st = _strides([qu, qv, k, v, o, do, dq, dk_, dv], [p, dp])
    rc = build.load().rel_attention_bwd(
        qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(),
        p.data_ptr(), o.data_ptr(), do.data_ptr(), lens.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), part.data_ptr(), duv.data_ptr(),
        dq.data_ptr(), dk_.data_ptr(), dv.data_ptr(), dp.data_ptr(),
        ctypes.addressof(st), B, H, T, GROUP, SCALE,
        torch.cuda.current_stream(qu.device).cuda_stream)
    build.check(rc, "rel_attention_bwd")
    rel_attention_backward.launches += 1
    du, dvb = duv.sum((0, 1))
    return dq, du, dvb, dk_, dv, dp


class _RelAttention(torch.autograd.Function):
    """K9 forward, saving qu, qv and the log-sum-exp; K9 backward."""

    @staticmethod
    def forward(ctx, q, u, vb, k, v, p, lens):
        o, lse, qu, qv = _forward(q, u, vb, k, v, p, lens, save=True)
        ctx.save_for_backward(qu, qv, k, v, p, lens, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return (*rel_attention_backward(*ctx.saved_tensors, do), None)


def rel_attention(q: torch.Tensor, u: torch.Tensor, vb: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """``attention_core`` at dropout 0 on CUDA tensors: q, k, v ``[B, H,
    T, 64]``, p ``[H, 2T-1, 64]`` bf16, the biases u, vb ``[H, 64]`` f32,
    ``lens`` [B] int32 (keys and queries at or past a row's length are
    padding) -> ``[B, H, T, 64]`` bf16. A differentiable call (grad
    enabled, an input that requires it) goes through the autograd
    function; any other runs the forward kernel alone."""
    require_kernel_device(q)
    B, H, T, dk = q.shape
    if dk != HEAD_DIM:
        raise ValueError(f"the fused attention kernel takes d_k = "
                         f"{HEAD_DIM}, got {dk}")
    shape = (B, H, T, dk)
    q, k, v = (_kernel_view(n, t, shape) for n, t in
               (("q", q), ("k", k), ("v", v)))
    p = _kernel_view("p", p, (H, 2 * T - 1, dk))
    u, vb = (_checked(n, t, (H, dk), torch.float32).contiguous()
             for n, t in (("u", u), ("vb", vb)))
    lens = _checked("lens", lens, (B,), torch.int32).contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, u, vb, k, v, p)):
        return _RelAttention.apply(q, u, vb, k, v, p, lens)
    return _forward(q, u, vb, k, v, p, lens, save=False)[0]


rel_attention.launches = 0
rel_attention_backward.launches = 0
