"""Fused (bi)LSTM forward recurrence: the wrapper of the CUDA kernel
``csrc/lstm_fwd.cu`` and its plain PyTorch version.

Replaces the forward half of ``ctc_asr_tpu/ops/lstm_pallas.py``
(``_fwd_kernel``, launched by ``_run_fwd`` / ``lstm_seq_pallas``) for
inference: direction-major inputs, bias added inside, per-row
``[start, end)`` windows, f32 h/c state, bf16 h output. The input
projections ``x @ wx`` stay outside (``torch.matmul``), as the
reference leaves them to XLA.
"""

from __future__ import annotations

import torch

from . import build
from .dispatch import check_kernel_tensor, require_kernel_device


def lstm_seq_plain(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """The recurrence in plain PyTorch; returns f32 [nd, T, B, H].

    xproj [nd, T, B, 4H] (x @ wx, bias not added); b [nd, 4H];
    wh [nd, H, 4H]; start/end [nd, B] int. The product ``h @ wh`` takes
    h rounded to wh's dtype and accumulates in f32, as the reference
    does for its compute dtype: with bf16 xproj/wh this is the kernel's
    arithmetic, with f32 the reference's ``lax.scan`` path."""
    nd, T, B, G = xproj.shape
    H = wh.shape[1]
    whf = wh.float()
    bf = b.float()[:, None, :]
    h = torch.zeros((nd, B, H), dtype=torch.float32, device=xproj.device)
    c = torch.zeros_like(h)
    out = torch.empty((nd, T, B, H), dtype=torch.float32, device=xproj.device)
    start = start.reshape(nd, B, 1)
    end = end.reshape(nd, B, 1)
    for t in range(T):
        gates = (xproj[:, t].float() + bf) + torch.bmm(
            h.to(wh.dtype).float(), whf)
        gi, gf, gg, go = gates.split(H, dim=-1)
        gi, gf, go = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        c_new = gf * c + gi * torch.tanh(gg)
        h_new = go * torch.tanh(c_new)
        m = ((t >= start) & (t < end)).float()
        c = m * c_new + (1.0 - m) * c
        h = m * h_new + (1.0 - m) * h
        out[:, t] = h * m
    return out


def lstm_seq(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
             start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Masked hidden outputs [nd, T, B, H] bf16 of one (bi)LSTM layer.

    xproj [nd, T, B, 4H] bf16; b [nd, 4H] f32; wh [nd, H, 4H] bf16;
    start/end [nd, B] int32. A CPU tensor gets the plain version; a
    CUDA tensor launches the kernel (and raises if it cannot)."""
    if xproj.device.type == "cpu":
        return lstm_seq_plain(xproj, b, wh, start, end).to(torch.bfloat16)
    require_kernel_device(xproj)
    nd, T, B, G = xproj.shape
    H = G // 4
    if G != 4 * H or H % 16:
        raise ValueError(f"the kernel needs 4*H gates with H % 16 == 0, "
                         f"got a last dim of {G}")
    check_kernel_tensor("xproj", xproj, torch.bfloat16, (nd, T, B, G))
    check_kernel_tensor("b", b, torch.float32, (nd, G))
    check_kernel_tensor("wh", wh, torch.bfloat16, (nd, H, G))
    check_kernel_tensor("start", start, torch.int32, (nd, B))
    check_kernel_tensor("end", end, torch.int32, (nd, B))
    if xproj.data_ptr() % 16 or wh.data_ptr() % 16:
        raise ValueError("xproj and wh must be 16-byte aligned")
    dev = xproj.device
    h_out = torch.empty((nd, T, B, H), dtype=torch.bfloat16, device=dev)
    hbuf = torch.zeros((2, nd, B, H), dtype=torch.float32, device=dev)
    hb16 = torch.zeros((2, nd, B, H), dtype=torch.bfloat16, device=dev)
    cbuf = torch.zeros((nd, B, H), dtype=torch.float32, device=dev)
    lib = build.load()
    rc = lib.lstm_fwd_seq(
        xproj.data_ptr(), b.data_ptr(), wh.data_ptr(), start.data_ptr(),
        end.data_ptr(), hbuf.data_ptr(), hb16.data_ptr(), cbuf.data_ptr(),
        h_out.data_ptr(), nd, T, B, H,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "lstm_fwd_seq")
    lstm_seq.launches += 1
    return h_out


lstm_seq.launches = 0
