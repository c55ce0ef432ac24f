"""Fused (bi)LSTM recurrence: the wrappers of the CUDA kernels
``csrc/lstm_fwd.cu`` (forward, K2) and ``csrc/lstm_bwd.cu`` (BPTT, K3),
their plain PyTorch versions, and the autograd function that joins them.

Replaces ``ctc_asr_tpu/ops/lstm_pallas.py``: ``_fwd_kernel`` and
``_bwd_kernel`` with the custom VJP of ``lstm_seq_pallas``.
Direction-major inputs ``[nd, T, B, *]``, bias added inside, per-row
``[start, end)`` windows, f32 h/c state, bf16 outputs and residuals.
The input projections ``x @ wx`` and the recurrent weight gradient
``dwh`` (one large matmul per direction, ``_dwh_from_seq``) stay
outside the kernels (``torch.matmul``), as the reference leaves them to
XLA.
"""

from __future__ import annotations

import torch

from . import build
from .dispatch import check_kernel_tensor, require_kernel_device

_BT = 32   # batch rows per block of the BPTT kernel (lstm_bwd.cu: BT)


def _window(start, end, t, shape):
    return ((t >= start) & (t < end)).float().reshape(shape)


def lstm_fwd_plain(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor):
    """The forward recurrence in plain PyTorch: (h, c, gates), f32
    ``[nd, T, B, H]``, ``[nd, T, B, H]``, ``[nd, T, B, 4H]``.

    xproj [nd, T, B, 4H] (x @ wx, bias not added); b [nd, 4H];
    wh [nd, H, 4H]; start/end [nd, B] int. The product ``h @ wh`` takes
    h rounded to wh's dtype and accumulates in f32, as the reference
    does for its compute dtype: with bf16 xproj/wh this is the kernel's
    arithmetic, with f32 the reference's ``lax.scan`` path. h is the
    masked output, c the carried state, gates the activated [i, f, g, o]
    (``lstm_pallas.py:212-233``). Differentiable: autograd through it is
    the scan path's gradient."""
    nd, T, B, G = xproj.shape
    H = wh.shape[1]
    bf = b.float()[:, None, :]
    h = torch.zeros((nd, B, H), dtype=torch.float32, device=xproj.device)
    c = torch.zeros_like(h)
    hs, cs, gs = [], [], []
    for t in range(T):
        # wh is cast inside the loop so that autograd rounds each step's
        # dwh to wh's dtype and sums them in it, as the scan's transpose
        # does for its bf16 operand
        pre = (xproj[:, t].float() + bf) + torch.bmm(h.to(wh.dtype).float(),
                                                     wh.float())
        gi, gf, gg, go = pre.split(H, dim=-1)
        gi, gf, go = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        gg = torch.tanh(gg)
        c_new = gf * c + gi * gg
        h_new = go * torch.tanh(c_new)
        m = _window(start, end, t, (nd, B, 1))
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        hs.append(h * m)
        cs.append(c)
        gs.append(torch.cat([gi, gf, gg, go], dim=-1))
    if T == 0:
        return (h.new_zeros((nd, 0, B, H)), h.new_zeros((nd, 0, B, H)),
                h.new_zeros((nd, 0, B, G)))
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(gs, 1)


def lstm_seq_plain(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Masked hidden outputs f32 [nd, T, B, H] of ``lstm_fwd_plain``."""
    return lstm_fwd_plain(xproj, b, wh, start, end)[0]


def _check_fwd_args(xproj, b, wh, start, end):
    nd, T, B, G = xproj.shape
    H = G // 4
    if G != 4 * H or H % 16:
        raise ValueError(f"the kernels need 4*H gates with H % 16 == 0, "
                         f"got a last dim of {G}")
    check_kernel_tensor("xproj", xproj, torch.bfloat16, (nd, T, B, G))
    check_kernel_tensor("b", b, torch.float32, (nd, G))
    check_kernel_tensor("wh", wh, torch.bfloat16, (nd, H, G))
    check_kernel_tensor("start", start, torch.int32, (nd, B))
    check_kernel_tensor("end", end, torch.int32, (nd, B))
    if xproj.data_ptr() % 16 or wh.data_ptr() % 16:
        raise ValueError("xproj and wh must be 16-byte aligned")
    return nd, T, B, G, H


def lstm_fwd(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
             start: torch.Tensor, end: torch.Tensor,
             residuals: bool = False):
    """K2: masked h [nd, T, B, H] bf16, and with ``residuals`` also the
    carried c [nd, T, B, H] and activated gates [nd, T, B, 4H], bf16.

    xproj [nd, T, B, 4H] bf16; b [nd, 4H] f32; wh [nd, H, 4H] bf16;
    start/end [nd, B] int32. A CPU tensor gets the plain version
    (outputs rounded to bf16); a CUDA tensor launches the kernel (and
    raises if it cannot). Returns h, or (h, c, gates)."""
    if xproj.device.type == "cpu":
        outs = [o.to(torch.bfloat16)
                for o in lstm_fwd_plain(xproj, b, wh, start, end)]
        return tuple(outs) if residuals else outs[0]
    require_kernel_device(xproj)
    nd, T, B, G, H = _check_fwd_args(xproj, b, wh, start, end)
    dev = xproj.device
    h_out = torch.empty((nd, T, B, H), dtype=torch.bfloat16, device=dev)
    c_out = gates = None
    if residuals:
        c_out = torch.empty_like(h_out)
        gates = torch.empty((nd, T, B, G), dtype=torch.bfloat16, device=dev)
    if xproj.numel() == 0:     # no step or no row: nothing to launch
        return (h_out, c_out, gates) if residuals else h_out
    hbuf = torch.zeros((2, nd, B, H), dtype=torch.float32, device=dev)
    hb16 = torch.zeros((2, nd, B, H), dtype=torch.bfloat16, device=dev)
    cbuf = torch.zeros((nd, B, H), dtype=torch.float32, device=dev)
    rc = build.load().lstm_fwd_seq(
        xproj.data_ptr(), b.data_ptr(), wh.data_ptr(), start.data_ptr(),
        end.data_ptr(), hbuf.data_ptr(), hb16.data_ptr(), cbuf.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr() if residuals else None,
        gates.data_ptr() if residuals else None, nd, T, B, H,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "lstm_fwd_seq")
    lstm_fwd.launches += 1
    return (h_out, c_out, gates) if residuals else h_out


lstm_fwd.launches = 0


def lstm_seq(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
             start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Inference entry of K2: masked hidden outputs [nd, T, B, H] bf16.

    The kernel is cut off from autograd, so inputs that want a gradient
    are refused while grad mode is on: training goes through
    ``LstmSeq``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xproj, b, wh)):
        raise RuntimeError("lstm_seq is forward-only; use LstmSeq.apply "
                           "when gradients are wanted")
    return lstm_fwd(xproj, b, wh, start, end)


def lstm_bwd_plain(g_out: torch.Tensor, gates: torch.Tensor,
                   c_seq: torch.Tensor, wh: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor):
    """K3's plain version: BPTT of ``lstm_pallas.py:266-314`` in f32 on
    the bf16 residuals. Returns (dxproj [nd, T, B, 4H] f32 with values
    rounded to bf16, db [nd, 4H] f32)."""
    nd, T, B, G = gates.shape
    H = G // 4
    whb = wh.to(torch.bfloat16).float()
    dh = torch.zeros((nd, B, H), dtype=torch.float32, device=gates.device)
    dc = torch.zeros_like(dh)
    db = torch.zeros((nd, G), dtype=torch.float32, device=gates.device)
    dx = torch.empty((nd, T, B, G), dtype=torch.float32, device=gates.device)
    for t in range(T - 1, -1, -1):
        mf = _window(start, end, t, (nd, B, 1))
        gi, gf, gg, go = gates[:, t].float().split(H, dim=-1)
        c_t = c_seq[:, t].float()
        c_prev = c_seq[:, t - 1].float() if t > 0 else torch.zeros_like(c_t)
        tanh_c = torch.tanh(c_t)
        dh_total = dh + mf * g_out[:, t].float()
        dh_new = mf * dh_total
        d_o = dh_new * tanh_c
        dc_total = mf * dc + dh_new * go * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc_total * gg * gi * (1.0 - gi),
                            dc_total * c_prev * gf * (1.0 - gf),
                            dc_total * gi * (1.0 - gg * gg),
                            d_o * go * (1.0 - go)], dim=-1)
        dgb = dgates.to(torch.bfloat16).float()
        dx[:, t] = dgb
        db += dgates.sum(dim=1)
        dh = (1.0 - mf) * dh_total + torch.bmm(dgb, whb.transpose(1, 2))
        dc = (1.0 - mf) * dc + dc_total * gf
    return dx, db


def lstm_bwd(g_out: torch.Tensor, gates: torch.Tensor, c_seq: torch.Tensor,
             wh: torch.Tensor, start: torch.Tensor, end: torch.Tensor):
    """K3: (dxproj [nd, T, B, 4H] bf16, db [nd, 4H] f32) from the bf16
    cotangent of h and the forward's bf16 residuals. A CPU tensor gets
    the plain version; a CUDA tensor launches the kernel (and raises if
    it cannot)."""
    if g_out.device.type == "cpu":
        dx, db = lstm_bwd_plain(g_out, gates, c_seq, wh, start, end)
        return dx.to(torch.bfloat16), db
    require_kernel_device(g_out)
    nd, T, B, G = gates.shape
    H = G // 4
    if G != 4 * H or H % 16:
        raise ValueError(f"the kernels need 4*H gates with H % 16 == 0, "
                         f"got a last dim of {G}")
    check_kernel_tensor("g_out", g_out, torch.bfloat16, (nd, T, B, H))
    check_kernel_tensor("gates", gates, torch.bfloat16, (nd, T, B, G))
    check_kernel_tensor("c_seq", c_seq, torch.bfloat16, (nd, T, B, H))
    check_kernel_tensor("wh", wh, torch.bfloat16, (nd, H, G))
    check_kernel_tensor("start", start, torch.int32, (nd, B))
    check_kernel_tensor("end", end, torch.int32, (nd, B))
    if wh.data_ptr() % 16:
        raise ValueError("wh must be 16-byte aligned")
    dev = g_out.device
    dxproj = torch.empty((nd, T, B, G), dtype=torch.bfloat16, device=dev)
    nbt = -(-B // _BT)
    db_part = torch.zeros((nbt, nd, G), dtype=torch.float32, device=dev)
    if gates.numel() == 0:     # no step or no row: nothing to launch
        return dxproj, db_part.sum(dim=0)
    dh = torch.zeros((nd, B, H), dtype=torch.float32, device=dev)
    dc = torch.zeros_like(dh)
    rc = build.load().lstm_bwd_seq(
        g_out.data_ptr(), gates.data_ptr(), c_seq.data_ptr(), wh.data_ptr(),
        start.data_ptr(), end.data_ptr(), dh.data_ptr(), dc.data_ptr(),
        dxproj.data_ptr(), db_part.data_ptr(), nd, T, B, H,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "lstm_bwd_seq")
    lstm_bwd.launches += 1
    return dxproj, db_part.sum(dim=0)


lstm_bwd.launches = 0


def dwh_from_seq(h_seq: torch.Tensor, dxproj: torch.Tensor) -> torch.Tensor:
    """dwh[d] = sum_t h[t-1]^T @ dgates[t] as one matmul per direction
    (``lstm_pallas._dwh_from_seq``): h_seq is the masked output, shifted
    one step, zeros at t = 0. bf16 operands, f32 result [nd, H, 4H]."""
    nd, T, B, H = h_seq.shape
    G = dxproj.shape[-1]
    hp = torch.cat([torch.zeros_like(h_seq[:, :1]), h_seq[:, :-1]], dim=1)
    hp = hp.reshape(nd, T * B, H)
    dg = dxproj.reshape(nd, T * B, G)
    if hp.is_cuda:
        return torch.bmm(hp.transpose(1, 2), dg).float()
    return torch.bmm(hp.float().transpose(1, 2), dg.float())


class LstmSeq(torch.autograd.Function):
    """Fused (bi)LSTM with BPTT: forward = K2 with residuals, backward =
    K3 plus ``dwh_from_seq``. Gradient dtypes as the reference's
    (``lstm_pallas.py:459-460``): dxproj bf16, db f32, dwh in wh's."""

    @staticmethod
    def forward(ctx, xproj, b, wh, start, end):
        h, c, gates = lstm_fwd(xproj, b, wh, start, end, residuals=True)
        ctx.save_for_backward(h, c, gates, wh, start, end)
        return h

    @staticmethod
    def backward(ctx, g_out):
        h, c, gates, wh, start, end = ctx.saved_tensors
        dxproj, db = lstm_bwd(g_out.to(torch.bfloat16).contiguous(), gates,
                              c, wh, start, end)
        dwh = dwh_from_seq(h, dxproj)
        return dxproj, db, dwh.to(wh.dtype), None, None
