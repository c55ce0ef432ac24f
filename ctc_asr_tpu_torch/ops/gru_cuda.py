"""Fused (bi)GRU recurrence: the wrappers of the CUDA kernels
``csrc/gru_fwd.cu`` (forward, K4) and ``csrc/gru_bwd.cu`` (BPTT, K5),
their plain PyTorch versions, and the autograd function that joins them.

Replaces the GRU half of ``ctc_asr_tpu/ops/lstm_pallas.py``:
``_gru_fwd_kernel`` and ``_gru_bwd_kernel`` with the custom VJP of
``gru_seq_pallas``. Direction-major inputs ``[nd, T, B, *]``, gate order
r, z, n, bias added inside, per-row ``[start, end)`` windows, f32 h
state, bf16 outputs and residuals. The residual is ``[.., 4H] = (r, z,
n, hn)``: ``n = tanh(xn + r * hn)`` keeps the recurrent product's
n-third ``hn`` apart from the input's, and BPTT needs it. The input
projections ``x @ wx`` and the recurrent weight gradient ``dwh`` (one
large matmul per direction, ``lstm_cuda.dwh_from_seq``) stay outside
the kernels (``torch.bmm``), as the reference leaves them to XLA.

On the card each kernel is one cooperative launch a layer on the plan
``lstm_cuda.plan_recurrence(..., gate_mult=3)`` gives (see
``ops/lstm_cuda.py``); a shape with no plan raises before any launch.
"""

from __future__ import annotations

import torch

from . import build
from .dispatch import check_kernel_tensor, require_kernel_device
from .lstm_cuda import _window, dwh_from_seq, require_plan


def gru_fwd_plain(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
                  start: torch.Tensor, end: torch.Tensor):
    """The forward recurrence in plain PyTorch: (h [nd, T, B, H],
    gates [nd, T, B, 4H]), f32.

    xproj [nd, T, B, 3H] (x @ wx, bias not added); b [nd, 3H];
    wh [nd, H, 3H]; start/end [nd, B] int. The product ``h @ wh`` takes
    h rounded to wh's dtype and accumulates in f32, as the reference
    does for its compute dtype: with bf16 xproj/wh this is the kernel's
    arithmetic, with f32 the reference's ``lax.scan`` path. h is the
    masked output; gates is (r, z, n, hn), written at every step, also
    where the row is masked (``lstm_pallas.py:497-507``). Differentiable:
    autograd through it is the scan path's gradient."""
    nd, T, B, G = xproj.shape
    H = wh.shape[1]
    bf = b.float()[:, None, :]
    h = torch.zeros((nd, B, H), dtype=torch.float32, device=xproj.device)
    hs, gs = [], []
    for t in range(T):
        xr, xz, xn = (xproj[:, t].float() + bf).split(H, dim=-1)
        # wh is cast inside the loop so that autograd rounds each step's
        # dwh to wh's dtype and sums them in it (see lstm_fwd_plain)
        hr, hz, hn = torch.bmm(h.to(wh.dtype).float(),
                               wh.float()).split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        m = _window(start, end, t, (nd, B, 1))
        h = m * h_new + (1.0 - m) * h
        hs.append(h * m)
        gs.append(torch.cat([r, z, n, hn], dim=-1))
    if T == 0:
        return h.new_zeros((nd, 0, B, H)), h.new_zeros((nd, 0, B, 4 * H))
    return torch.stack(hs, 1), torch.stack(gs, 1)


def gru_seq_plain(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
                  start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Masked hidden outputs f32 [nd, T, B, H] of ``gru_fwd_plain``."""
    return gru_fwd_plain(xproj, b, wh, start, end)[0]


def _check_dims(G: int, H: int) -> None:
    if G != 3 * H or H % 16:
        raise ValueError(f"the kernels need 3*H gates with H % 16 == 0, "
                         f"got a last dim of {G} for H = {H}")


def gru_fwd(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
            start: torch.Tensor, end: torch.Tensor, residuals: bool = False):
    """K4: masked h [nd, T, B, H] bf16, and with ``residuals`` also the
    gates (r, z, n, hn) [nd, T, B, 4H] bf16.

    xproj [nd, T, B, 3H] bf16; b [nd, 3H] f32; wh [nd, H, 3H] bf16;
    start/end [nd, B] int32. A CPU tensor gets the plain version
    (outputs rounded to bf16); a CUDA tensor launches the kernel on the
    plan ``plan_recurrence`` gives, and raises where there is none or
    the launch fails. Returns h, or (h, gates)."""
    if xproj.device.type == "cpu":
        h, gates = (o.to(torch.bfloat16)
                    for o in gru_fwd_plain(xproj, b, wh, start, end))
        return (h, gates) if residuals else h
    require_kernel_device(xproj)
    nd, T, B, G = xproj.shape
    H = G // 3
    _check_dims(G, H)
    check_kernel_tensor("xproj", xproj, torch.bfloat16, (nd, T, B, G))
    check_kernel_tensor("b", b, torch.float32, (nd, G))
    check_kernel_tensor("wh", wh, torch.bfloat16, (nd, H, G))
    check_kernel_tensor("start", start, torch.int32, (nd, B))
    check_kernel_tensor("end", end, torch.int32, (nd, B))
    if xproj.data_ptr() % 16 or wh.data_ptr() % 16:
        raise ValueError("xproj and wh must be 16-byte aligned")
    dev = xproj.device
    h_out = torch.empty((nd, T, B, H), dtype=torch.bfloat16, device=dev)
    gates = (torch.empty((nd, T, B, 4 * H), dtype=torch.bfloat16, device=dev)
             if residuals else None)
    if xproj.numel() == 0:     # no step or no row: nothing to launch
        return (h_out, gates) if residuals else h_out
    plan = require_plan(dev, nd, B, H, gate_mult=3)
    # the h exchange (never read before it is written) and the barrier
    # counters are the only scratch
    hb16 = torch.empty((2, nd, B, H), dtype=torch.bfloat16, device=dev)
    sync = torch.zeros(nd * plan.grid[1], dtype=torch.int32, device=dev)
    rc = build.load().gru_fwd_persistent(
        xproj.data_ptr(), b.data_ptr(), wh.data_ptr(), start.data_ptr(),
        end.data_ptr(), hb16.data_ptr(), sync.data_ptr(), h_out.data_ptr(),
        gates.data_ptr() if residuals else None, nd, T, B, H, plan.jt,
        plan.bt, plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gru_fwd_persistent")
    gru_fwd.launches += 1
    return (h_out, gates) if residuals else h_out


gru_fwd.launches = 0            # one kernel a call


def gru_seq(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
            start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Inference entry of K4: masked hidden outputs [nd, T, B, H] bf16.

    The kernel is cut off from autograd, so inputs that want a gradient
    are refused while grad mode is on: training goes through
    ``GruSeq``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xproj, b, wh)):
        raise RuntimeError("gru_seq is forward-only; use GruSeq.apply "
                           "when gradients are wanted")
    return gru_fwd(xproj, b, wh, start, end)


def gru_bwd_plain(g_out: torch.Tensor, gates: torch.Tensor,
                  h_seq: torch.Tensor, wh: torch.Tensor,
                  start: torch.Tensor, end: torch.Tensor,
                  exact: bool = False):
    """K5's plain version: BPTT of ``lstm_pallas.py:525-563`` in f32 on
    the bf16 residuals. Returns (dxproj [nd, T, B, 3H] f32 with values
    rounded to bf16, db [nd, 3H] f32).

    h[t-1] is the masked bf16 output (0 at t = 0), not the f32 state:
    right because outside a row's window either ``dh_new`` is 0 or the
    carried h is 0. The recurrent product takes d(hproj) = (dr_pre,
    dz_pre, dn_pre * r), formed in f32 and rounded to bf16 once.

    ``exact`` gives the same BPTT in f64 with nothing rounded (f64
    outputs): the oracle that the kernel and this version are both held
    against where their difference is the rounding of dhproj alone."""
    nd, T, B, G4 = gates.shape
    H = G4 // 4
    ft = torch.float64 if exact else torch.float32

    def rnd(v):
        return v if exact else v.to(torch.bfloat16).to(ft)

    whb = wh.to(torch.bfloat16).to(ft)
    dev = gates.device
    dh = torch.zeros((nd, B, H), dtype=ft, device=dev)
    db = torch.zeros((nd, 3 * H), dtype=ft, device=dev)
    dx = torch.empty((nd, T, B, 3 * H), dtype=ft, device=dev)
    for t in range(T - 1, -1, -1):
        mf = _window(start, end, t, (nd, B, 1)).to(ft)
        r, z, n, hn = gates[:, t].to(ft).split(H, dim=-1)
        h_prev = h_seq[:, t - 1].to(ft) if t > 0 else torch.zeros_like(dh)
        dh_total = dh + mf * g_out[:, t].to(ft)
        dh_new = mf * dh_total
        dz = dh_new * (h_prev - n)
        dn_pre = dh_new * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dgates = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dx[:, t] = rnd(dgates)
        db += dgates.sum(dim=1)
        dhproj = rnd(torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1))
        dh = ((1.0 - mf) * dh_total + dh_new * z
              + torch.bmm(dhproj, whb.transpose(1, 2)))
    return dx, db


def gru_bwd(g_out: torch.Tensor, gates: torch.Tensor, h_seq: torch.Tensor,
            wh: torch.Tensor, start: torch.Tensor, end: torch.Tensor):
    """K5: (dxproj [nd, T, B, 3H] bf16, db [nd, 3H] f32) from the bf16
    cotangent of h and the forward's bf16 residuals (gates (r, z, n, hn)
    and the masked h). A CPU tensor gets the plain version; a CUDA
    tensor launches the kernel on the plan ``plan_recurrence`` gives,
    and raises where there is none or the launch fails."""
    if g_out.device.type == "cpu":
        dx, db = gru_bwd_plain(g_out, gates, h_seq, wh, start, end)
        return dx.to(torch.bfloat16), db
    require_kernel_device(g_out)
    nd, T, B, G4 = gates.shape
    H = G4 // 4
    G = 3 * H
    if G4 != 4 * H:
        raise ValueError(f"gates must be [.., 4H] = (r, z, n, hn), got a "
                         f"last dim of {G4}")
    _check_dims(G, H)
    check_kernel_tensor("g_out", g_out, torch.bfloat16, (nd, T, B, H))
    check_kernel_tensor("gates", gates, torch.bfloat16, (nd, T, B, G4))
    check_kernel_tensor("h_seq", h_seq, torch.bfloat16, (nd, T, B, H))
    check_kernel_tensor("wh", wh, torch.bfloat16, (nd, H, G))
    check_kernel_tensor("start", start, torch.int32, (nd, B))
    check_kernel_tensor("end", end, torch.int32, (nd, B))
    if wh.data_ptr() % 16:
        raise ValueError("wh must be 16-byte aligned")
    dev = g_out.device
    dxproj = torch.empty((nd, T, B, G), dtype=torch.bfloat16, device=dev)
    if gates.numel() == 0:     # no step or no row: nothing to launch
        return dxproj, torch.zeros((nd, G), dtype=torch.float32, device=dev)
    plan = require_plan(dev, nd, B, H, gate_mult=3, backward=True)
    # d(hproj) of the step before, ping-ponged: step t reads what step
    # t + 1 wrote and writes the other half; one db partial per row
    # block, each element written once
    dhproj = torch.empty((2, nd, B, G), dtype=torch.bfloat16, device=dev)
    db_part = torch.empty((plan.grid[1], nd, G), dtype=torch.float32,
                          device=dev)
    sync = torch.zeros(nd * plan.grid[1], dtype=torch.int32, device=dev)
    rc = build.load().gru_bwd_persistent(
        g_out.data_ptr(), gates.data_ptr(), h_seq.data_ptr(), wh.data_ptr(),
        start.data_ptr(), end.data_ptr(), dhproj.data_ptr(),
        dxproj.data_ptr(), db_part.data_ptr(), sync.data_ptr(), nd, T, B, H,
        plan.jt, plan.bt, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "gru_bwd_persistent")
    gru_bwd.launches += 1
    return dxproj, db_part.sum(dim=0)


gru_bwd.launches = 0            # one kernel a call


class GruSeq(torch.autograd.Function):
    """Fused (bi)GRU with BPTT: forward = K4 with residuals, backward =
    K5 plus ``dwh_from_seq``. Gradient dtypes as the reference's
    (``lstm_pallas.py:670-671``): dxproj bf16, db f32, dwh in wh's."""

    @staticmethod
    def forward(ctx, xproj, b, wh, start, end):
        h, gates = gru_fwd(xproj, b, wh, start, end, residuals=True)
        ctx.save_for_backward(h, gates, wh, start, end)
        return h

    @staticmethod
    def backward(ctx, g_out):
        h, gates, wh, start, end = ctx.saved_tensors
        H = wh.shape[1]
        dxproj, db = gru_bwd(g_out.to(torch.bfloat16).contiguous(), gates,
                             h, wh, start, end)
        # dwh's n-columns take d(hproj_n) = dn_pre * r, rebuilt from the
        # bf16 dxproj and the saved bf16 r, as the reference rebuilds it
        # (lstm_pallas.py:662-667)
        dhproj = torch.cat([dxproj[..., :2 * H],
                            dxproj[..., 2 * H:] * gates[..., :H]], dim=-1)
        dwh = dwh_from_seq(h, dhproj)
        return dxproj, db, dwh.to(wh.dtype), None, None
