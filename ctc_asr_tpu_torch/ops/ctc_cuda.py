"""CTC loss: the plain log-space forward DP, the wrappers of the CUDA
kernels ``csrc/ctc.cu`` (α: K6, β and gradient: K7), and the autograd
function that joins them.

Counterpart of ``ctc_asr_tpu/ops/ctc_ref.py`` (the plain DP, whose
autograd gradient is the reference's) and ``ctc_asr_tpu/ops/ctc_pallas.py``
(``_alpha_kernel``, ``_beta_kernel`` and the custom VJP
``_ctc_nll_from_lpz``). Conventions are the reference's:

- logits are pre-softmax ``[B, T, C]``, blank is the last class;
- the DP runs over the blank-interleaved extended labels, S = 2U+1
  states, time-major ``lp_z [T, B, S]``;
- log-space arithmetic uses the finite sentinel ``NEG_INF = -1e30`` and
  a max-clamped three-way log-sum-exp, never ``-inf``;
- rows past their length carry α unchanged; the NLL is read from states
  2U and 2U-1; an infeasible row gives +inf.

``log_softmax`` and the label gather stay in torch outside the autograd
function, as they stay in XLA in the reference; ``CtcNll`` wraps only
the DP, and its backward is K7's ``-exp(α+β-logP)`` scaled by the
per-row cotangent. The gather is ``LabelGather``, whose backward sums
the states of a class in a fixed order, so that a step on the card
gives the same bits from the same inputs.
"""

from __future__ import annotations

import torch

from ..text import BLANK_ID

from . import build
from .dispatch import check_kernel_tensor, require_kernel_device

NEG_INF = -1.0e30
MAX_STATES = 1024     # one thread per extended-label state in the kernels


def extended_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, U] labels -> [B, 2U+1] (blank, l1, blank, l2, ..., blank)."""
    B, U = labels.shape
    z = torch.full((B, 2 * U + 1), blank_id, dtype=labels.dtype,
                   device=labels.device)
    z[:, 1::2] = labels
    return z


def can_skip(z: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, S] float: 1 where the skip s-2 -> s is allowed (a label state,
    s >= 2, and z[s] != z[s-2])."""
    B, S = z.shape
    s_idx = torch.arange(S, device=z.device)[None, :]
    z_prev2 = torch.cat([torch.full((B, 2), blank_id, dtype=z.dtype,
                                    device=z.device), z[:, :-2]], dim=1)
    return (((s_idx % 2) == 1) & (z != z_prev2) & (s_idx >= 2)).float()


def _lse3(a, b, c):
    m = torch.clamp_min(torch.maximum(torch.maximum(a, b), c), NEG_INF)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                        + torch.exp(c - m))
    return torch.clamp_min(out, NEG_INF)


def _shift_right(x, k):
    """x[:, s] <- x[:, s-k], NEG_INF in the first k states."""
    return torch.cat([torch.full_like(x[:, :k], NEG_INF), x[:, :-k]], dim=1)


def _shift_left(x, k, fill=NEG_INF):
    """x[:, s] <- x[:, s+k], ``fill`` in the last k states."""
    return torch.cat([x[:, k:], torch.full_like(x[:, :k], fill)], dim=1)


def _end_states(ends: torch.Tensor, S: int) -> torch.Tensor:
    """[B, S] bool: states 2U and 2U-1 (the latter only when U > 0)."""
    lane = torch.arange(S, device=ends.device)[None, :]
    e = ends[:, None]
    return (lane == e) | ((lane == e - 1) & (e > 0))


def ctc_alpha_plain(lpz: torch.Tensor, skip: torch.Tensor,
                    lens: torch.Tensor, ends: torch.Tensor):
    """K6's plain version: lpz [T, B, S] f32, skip [B, S] f32, lens/ends
    [B] int -> (alphas [T, B, S] f32, nll [B] f32), the NLL clamped at
    -NEG_INF for an infeasible row (``ctc_pallas.py:97-142``). Written
    in differentiable torch ops: autograd through it is the reference's
    ``ctc_loss_ref`` gradient."""
    T, B, S = lpz.shape
    lane = torch.arange(S, device=lpz.device)[None, :]
    valid1 = (ends > 0)[:, None]
    neg = torch.full_like(lpz[0], NEG_INF)
    alpha = torch.where((lane == 0) | ((lane == 1) & valid1), lpz[0], neg)
    skip_ok = skip > 0.5
    alphas = [alpha]
    for t in range(1, T):
        rec = _lse3(alpha, _shift_right(alpha, 1),
                    torch.where(skip_ok, _shift_right(alpha, 2), neg))
        new = torch.clamp_min(rec + lpz[t], NEG_INF)
        alpha = torch.where((t < lens)[:, None], new, alpha)
        alphas.append(alpha)
    masked = torch.where(_end_states(ends, S), alpha, neg)
    m = torch.clamp_min(masked.max(dim=1, keepdim=True).values, NEG_INF)
    total = m + torch.log(torch.exp(masked - m).sum(dim=1, keepdim=True))
    nll = -torch.clamp_min(total, NEG_INF)[:, 0]
    return torch.stack(alphas), nll


def ctc_beta_grad_plain(lpz: torch.Tensor, alphas: torch.Tensor,
                        skip: torch.Tensor, lens: torch.Tensor,
                        ends: torch.Tensor, nll: torch.Tensor) -> torch.Tensor:
    """K7's plain version: the β recursion in reverse time and the
    gradient of the per-row NLL with respect to lp_z,
    ``-exp(max(α+β, NEG) - logP)``, 0 where t >= len
    (``ctc_pallas.py:149-193``). Returns [T, B, S] f32."""
    T, B, S = lpz.shape
    neg = torch.full_like(lpz[0], NEG_INF)
    init_row = torch.where(_end_states(ends, S), torch.zeros_like(neg), neg)
    skip_ok = _shift_left(skip, 2, fill=0.0) > 0.5
    logp = -nll[:, None]
    beta, plpz = neg, neg
    grad = torch.empty_like(lpz)
    for t in range(T - 1, -1, -1):
        x = torch.clamp_min(plpz + beta, NEG_INF)
        rec = _lse3(x, _shift_left(x, 1),
                    torch.where(skip_ok, _shift_left(x, 2), neg))
        beta = torch.where((t == lens - 1)[:, None], init_row,
                           torch.where((t < lens - 1)[:, None], rec, neg))
        plpz = lpz[t]
        g = -torch.exp(torch.clamp_min(alphas[t] + beta, NEG_INF) - logp)
        grad[t] = torch.where((t < lens)[:, None], g, torch.zeros_like(g))
    return grad


def _check_dp_args(lpz, skip, lens, ends):
    T, B, S = lpz.shape
    if S > MAX_STATES:
        raise ValueError(f"the CTC kernels take at most {MAX_STATES} "
                         f"extended-label states, got S={S}")
    check_kernel_tensor("lpz", lpz, torch.float32, (T, B, S))
    check_kernel_tensor("skip", skip, torch.float32, (B, S))
    check_kernel_tensor("lens", lens, torch.int32, (B,))
    check_kernel_tensor("ends", ends, torch.int32, (B,))


def ctc_alpha(lpz: torch.Tensor, skip: torch.Tensor, lens: torch.Tensor,
              ends: torch.Tensor):
    """(alphas [T, B, S], nll [B]). A CPU tensor gets the plain version;
    a CUDA tensor launches K6 (and raises if it cannot)."""
    if lpz.device.type == "cpu":
        return ctc_alpha_plain(lpz, skip, lens, ends)
    require_kernel_device(lpz)
    _check_dp_args(lpz, skip, lens, ends)
    T, B, S = lpz.shape
    alphas = torch.empty_like(lpz)
    nll = torch.empty((B,), dtype=torch.float32, device=lpz.device)
    rc = build.load().ctc_alpha(
        lpz.data_ptr(), skip.data_ptr(), lens.data_ptr(), ends.data_ptr(),
        alphas.data_ptr(), nll.data_ptr(), T, B, S,
        torch.cuda.current_stream(lpz.device).cuda_stream)
    build.check(rc, "ctc_alpha")
    ctc_alpha.launches += 1
    return alphas, nll


ctc_alpha.launches = 0


def ctc_beta_grad(lpz: torch.Tensor, alphas: torch.Tensor,
                  skip: torch.Tensor, lens: torch.Tensor, ends: torch.Tensor,
                  nll: torch.Tensor) -> torch.Tensor:
    """d nll / d lp_z [T, B, S]. A CPU tensor gets the plain version; a
    CUDA tensor launches K7 (and raises if it cannot)."""
    if lpz.device.type == "cpu":
        return ctc_beta_grad_plain(lpz, alphas, skip, lens, ends, nll)
    require_kernel_device(lpz)
    _check_dp_args(lpz, skip, lens, ends)
    T, B, S = lpz.shape
    check_kernel_tensor("alphas", alphas, torch.float32, (T, B, S))
    check_kernel_tensor("nll", nll, torch.float32, (B,))
    grad = torch.empty_like(lpz)
    rc = build.load().ctc_beta_grad(
        lpz.data_ptr(), alphas.data_ptr(), skip.data_ptr(), lens.data_ptr(),
        ends.data_ptr(), nll.data_ptr(), grad.data_ptr(), T, B, S,
        torch.cuda.current_stream(lpz.device).cuda_stream)
    build.check(rc, "ctc_beta_grad")
    ctc_beta_grad.launches += 1
    return grad


ctc_beta_grad.launches = 0


class CtcNll(torch.autograd.Function):
    """Per-row NLL of the DP: forward = K6, backward = K7 times the
    per-row cotangent (``ctc_pallas.py:277-309``)."""

    @staticmethod
    def forward(ctx, lpz, skip, lens, ends):
        alphas, nll = ctc_alpha(lpz, skip, lens, ends)
        ctx.save_for_backward(lpz, alphas, skip, lens, ends, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        lpz, alphas, skip, lens, ends, nll = ctx.saved_tensors
        grad = ctc_beta_grad(lpz, alphas, skip, lens, ends, nll)
        return grad * g[None, :, None], None, None, None


class LabelGather(torch.autograd.Function):
    """``lp_z[b, t, s] = log_probs[b, t, z[b, s]]``, whose backward sums
    the states that share a class in a fixed order: the one-hot product
    ``g [B, T, S] x onehot(z) [B, S, C]``, one ``bmm``. ``torch.gather``'s
    backward is a ``scatter_add`` over the states, and the blank is U+1
    of them in each row: on the card those sums are made with atomics,
    in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, log_probs, z):
        ctx.save_for_backward(z)
        ctx.num_classes = log_probs.shape[-1]
        return torch.gather(log_probs, 2,
                            z[:, None, :].expand(-1, log_probs.shape[1], -1))

    @staticmethod
    def backward(ctx, g):
        z, = ctx.saved_tensors
        classes = torch.arange(ctx.num_classes, device=z.device)
        onehot = (z[:, :, None] == classes).to(g.dtype)        # [B, S, C]
        return torch.bmm(g, onehot), None


def ctc_nll(logits: torch.Tensor, logit_lengths: torch.Tensor,
            labels: torch.Tensor, label_lengths: torch.Tensor,
            blank_id: int = BLANK_ID, use_kernel: bool = True) -> torch.Tensor:
    """Per-utterance CTC NLL [B] f32; +inf where no alignment fits.

    ``use_kernel`` routes the DP through ``CtcNll`` (K6/K7 on a CUDA
    tensor, their plain versions on a CPU one); otherwise autograd runs
    through ``ctc_alpha_plain``."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    z = extended_labels(labels.long(), blank_id)                # [B, S]
    lpz = LabelGather.apply(log_probs, z)                        # [B, T, S]
    lpz = lpz.transpose(0, 1).contiguous()                      # [T, B, S]
    skip = can_skip(z, blank_id)
    lens = logit_lengths.to(torch.int32).contiguous()
    ends = (2 * label_lengths).to(torch.int32).contiguous()
    if use_kernel:
        nll = CtcNll.apply(lpz, skip, lens, ends)
    else:
        nll = ctc_alpha_plain(lpz, skip, lens, ends)[1]
    return torch.where(nll >= -NEG_INF / 2,
                       torch.full_like(nll, float("inf")), nll)


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = BLANK_ID, use_kernel: bool = True,
             average: str = "utterance") -> torch.Tensor:
    """Batch-reduced CTC loss (``ctc_ref.py:119-147``): infeasible rows
    count 0; "utterance" is the mean over finite rows, "label" the mean
    of NLL / label length, "sum" the sum."""
    nll = ctc_nll(logits, logit_lengths, labels, label_lengths, blank_id,
                  use_kernel)
    finite = torch.isfinite(nll)
    nll = torch.where(finite, nll, torch.zeros_like(nll))
    n = torch.clamp_min(finite.float().sum(), 1.0)
    if average == "utterance":
        return nll.sum() / n
    if average == "label":
        per = nll / torch.clamp_min(label_lengths.float(), 1.0)
        return per.sum() / n
    if average == "sum":
        return nll.sum()
    raise ValueError(f"unknown average mode {average!r}")
