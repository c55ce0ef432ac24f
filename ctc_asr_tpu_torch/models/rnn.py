"""LSTM layers, uni- and bidirectional.

Counterpart of ``ctc_asr_tpu/models/rnn.py`` (``lstm_apply``,
``birnn_apply``) for ``rnn_type="lstm"``; GRU and the vanilla RNN come
with a later slice. Time-major ``[T, B, F]`` in and out.

- The input projections ``x @ wx`` for all steps are one batched
  ``torch.bmm`` outside the recurrence.
- The kernel path (``use_kernel``, the reference's Pallas path) feeds
  the CUDA kernels bf16 xproj and wh, as the reference casts them for
  its kernel (``rnn.py:290``): the inference wrapper ``lstm_seq`` when
  no gradient is wanted, else the autograd function ``LstmSeq`` (K2
  with residuals forward, K3 backward).
- The plain path is the reference's ``lax.scan`` path: xproj from the
  compute-dtype operands accumulated in f32 (``preferred_element_type
  =float32``, ``rnn.py:95-97``, ``:367-371``), the recurrence in
  ``lstm_seq_plain``, and autograd through it when training.
- Masking: outside a row's valid window the state carries through and
  the output is 0. Bidirectional layers keep the reference's static
  flip: the backward direction reads the time-flipped input with
  window ``[T - len, T)`` and its output flips back.
"""

from __future__ import annotations

import torch

from ..ops.lstm_cuda import LstmSeq, lstm_seq, lstm_seq_plain


def _recurrence(xd: torch.Tensor, wx: torch.Tensor, b: torch.Tensor,
                wh: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                compute_dtype, use_kernel: bool) -> torch.Tensor:
    """Direction-major inputs xd [nd, T, B, F] -> h [nd, T, B, H]."""
    nd, T, B, F = xd.shape
    G = wx.shape[-1]
    x2 = xd.reshape(nd, T * B, F).to(compute_dtype)
    if use_kernel:
        xproj = torch.bmm(x2, wx.to(compute_dtype)).reshape(nd, T, B, G)
        args = (xproj.to(torch.bfloat16).contiguous(), b.float().contiguous(),
                wh.to(torch.bfloat16).contiguous(), start.contiguous(),
                end.contiguous())
        if torch.is_grad_enabled() and any(a.requires_grad
                                           for a in args[:3]):
            return LstmSeq.apply(*args)
        return lstm_seq(*args)
    xproj = torch.bmm(x2.float(), wx.to(compute_dtype).float()
                      ).reshape(nd, T, B, G)
    return lstm_seq_plain(xproj, b, wh.to(compute_dtype), start, end)


def lstm_apply(params: dict, x: torch.Tensor, lengths: torch.Tensor,
               compute_dtype=torch.bfloat16,
               use_kernel: bool = False) -> torch.Tensor:
    """params {"wx", "wh", "b"}; x [T, B, F] -> [T, B, H]."""
    T, B, _ = x.shape
    lens = lengths.to(torch.int32)
    start = torch.zeros((1, B), dtype=torch.int32, device=x.device)
    out = _recurrence(x[None], params["wx"][None], params["b"][None],
                      params["wh"][None], start, lens[None],
                      compute_dtype, use_kernel)
    return out[0]


def birnn_apply(params: dict, x: torch.Tensor, lengths: torch.Tensor,
                compute_dtype=torch.bfloat16,
                use_kernel: bool = False) -> torch.Tensor:
    """params {"fwd": {...}, "bwd": {...}}; x [T, B, F] -> [T, B, 2H]
    (forward half, then the backward half in natural time)."""
    T, B, _ = x.shape
    lens = lengths.to(torch.int32)
    start = torch.stack([torch.zeros_like(lens), T - lens])
    end = torch.stack([lens, torch.full_like(lens, T)])
    fwd, bwd = params["fwd"], params["bwd"]
    out = _recurrence(torch.stack([x, torch.flip(x, (0,))]),
                      torch.stack([fwd["wx"], bwd["wx"]]),
                      torch.stack([fwd["b"], bwd["b"]]),
                      torch.stack([fwd["wh"], bwd["wh"]]),
                      start, end, compute_dtype, use_kernel)
    return torch.cat([out[0], torch.flip(out[1], (0,))], dim=-1)
