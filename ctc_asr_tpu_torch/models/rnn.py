"""Recurrent layers: LSTM, GRU and the vanilla tanh RNN, uni- and
bidirectional.

Counterpart of ``ctc_asr_tpu/models/rnn.py`` (``lstm_apply``,
``gru_apply``, ``vanilla_apply``, ``rnn_apply``, ``birnn_apply``).
Time-major ``[T, B, F]`` in and out. Gate orders are the reference's:
LSTM i, f, g, o; GRU r, z, n.

- The input projections ``x @ wx`` for all steps are one batched
  ``torch.bmm`` outside the recurrence.
- The kernel path (``use_kernel``, the reference's Pallas path) feeds
  the CUDA kernels bf16 xproj and wh, as the reference casts them for
  its kernel (``rnn.py:290``): the inference wrappers ``lstm_seq`` /
  ``gru_seq`` when no gradient is wanted, else the autograd functions
  ``LstmSeq`` (K2 with residuals forward, K3 backward) / ``GruSeq``
  (K4, K5). The vanilla cell has no kernel in the reference (it stays
  on the scan path, ``encoder.py:141-142``), so here it always takes
  the plain recurrence.
- The plain path is the reference's ``lax.scan`` path: xproj from the
  compute-dtype operands accumulated in f32 (``preferred_element_type
  =float32``, ``rnn.py:95-97``, ``:367-371``), the recurrence in
  ``lstm_seq_plain`` / ``gru_seq_plain`` / ``vanilla_seq_plain``, and
  autograd through it when training.
- Masking: outside a row's valid window the state carries through and
  the output is 0. Bidirectional layers keep the reference's static
  flip: the backward direction reads the time-flipped input with
  window ``[T - len, T)`` and its output flips back.
"""

from __future__ import annotations

import torch

from ..ops.gru_cuda import GruSeq, gru_seq, gru_seq_plain
from ..ops.lstm_cuda import LstmSeq, _window, lstm_seq, lstm_seq_plain
from ..utils.profiling import span

RNN_TYPES = ("lstm", "gru", "rnn")
# the profiler range around a layer's recurrence alone (K2 / K4, and K3 /
# K5 through the backward node it creates), not its input projection
RECURRENCE_RANGE = "rnn.recurrence"


def vanilla_seq_plain(xproj: torch.Tensor, b: torch.Tensor, wh: torch.Tensor,
                      start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """The tanh recurrence ``h' = tanh(xproj + b + h @ wh)`` in plain
    PyTorch (``rnn.py:177-186``, ``:417-430``): masked outputs f32
    [nd, T, B, H] from xproj [nd, T, B, H], b [nd, H], wh [nd, H, H],
    start/end [nd, B]. h is rounded to wh's dtype for the product, which
    accumulates in f32, as in ``lstm_fwd_plain``."""
    nd, T, B, H = xproj.shape
    bf = b.float()[:, None, :]
    h = torch.zeros((nd, B, H), dtype=torch.float32, device=xproj.device)
    hs = []
    for t in range(T):
        h_new = torch.tanh((xproj[:, t].float() + bf)
                           + torch.bmm(h.to(wh.dtype).float(), wh.float()))
        m = _window(start, end, t, (nd, B, 1))
        h = m * h_new + (1.0 - m) * h
        hs.append(h * m)
    return torch.stack(hs, 1) if T else h.new_zeros((nd, 0, B, H))


def init_carry(rnn_type: str, shape, device) -> tuple:
    """The zero state of a cell: (h, c) for the LSTM, (h,) otherwise."""
    h = torch.zeros(shape, dtype=torch.float32, device=device)
    return (h, torch.zeros_like(h)) if rnn_type == "lstm" else (h,)


def cell_step(rnn_type: str, xg: torch.Tensor, hp: torch.Tensor,
              carry: tuple, m: torch.Tensor):
    """One masked step of a cell from its whole gate rows: ``xg = x @ wx
    + b`` and ``hp = h @ wh`` [..., G] f32, ``carry`` from
    ``init_carry``, ``m`` the window mask [..., 1] -> (carry, masked h).
    The arithmetic of ``lstm_fwd_plain`` / ``gru_fwd_plain`` /
    ``vanilla_seq_plain`` (and of the reference's scan cells): gate
    orders LSTM i, f, g, o and GRU r, z, n; outside the window the state
    carries through and the output is 0. The tensor- and
    sequence-parallel recurrences share it."""
    h = carry[0]
    H = h.shape[-1]
    if rnn_type == "lstm":
        gi, gf, gg, go = (xg + hp).split(H, dim=-1)
        gi, gf, go = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        c_new = gf * carry[1] + gi * torch.tanh(gg)
        h_new = go * torch.tanh(c_new)
        c = m * c_new + (1.0 - m) * carry[1]
        h = m * h_new + (1.0 - m) * h
        return (h, c), h * m
    if rnn_type == "gru":
        xr, xz, xn = xg.split(H, dim=-1)
        hr, hz, hn = hp.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        h_new = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
    elif rnn_type == "rnn":
        h_new = torch.tanh(xg + hp)
    else:
        raise ValueError(f"unknown rnn_type {rnn_type!r}")
    h = m * h_new + (1.0 - m) * h
    return (h,), h * m


_KERNEL_SEQ = {"lstm": (lstm_seq, LstmSeq), "gru": (gru_seq, GruSeq)}
_PLAIN_SEQ = {"lstm": lstm_seq_plain, "gru": gru_seq_plain,
              "rnn": vanilla_seq_plain}


def _recurrence(xd: torch.Tensor, wx: torch.Tensor, b: torch.Tensor,
                wh: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                compute_dtype, use_kernel: bool,
                rnn_type: str = "lstm") -> torch.Tensor:
    """Direction-major inputs xd [nd, T, B, F] -> h [nd, T, B, H]."""
    if rnn_type not in RNN_TYPES:
        raise ValueError(f"unknown rnn_type {rnn_type!r}")
    nd, T, B, F = xd.shape
    G = wx.shape[-1]
    x2 = xd.reshape(nd, T * B, F).to(compute_dtype)
    if use_kernel and rnn_type in _KERNEL_SEQ:
        seq, seq_grad = _KERNEL_SEQ[rnn_type]
        xproj = torch.bmm(x2, wx.to(compute_dtype)).reshape(nd, T, B, G)
        args = (xproj.to(torch.bfloat16).contiguous(), b.float().contiguous(),
                wh.to(torch.bfloat16).contiguous(), start.contiguous(),
                end.contiguous())
        with span(RECURRENCE_RANGE):
            if torch.is_grad_enabled() and any(a.requires_grad
                                               for a in args[:3]):
                return seq_grad.apply(*args)
            return seq(*args)
    xproj = torch.bmm(x2.float(), wx.to(compute_dtype).float()
                      ).reshape(nd, T, B, G)
    with span(RECURRENCE_RANGE):
        return _PLAIN_SEQ[rnn_type](xproj, b, wh.to(compute_dtype), start,
                                    end)


def rnn_apply(params: dict, x: torch.Tensor, lengths: torch.Tensor,
              rnn_type: str, compute_dtype=torch.bfloat16,
              use_kernel: bool = False,
              recurrence=_recurrence) -> torch.Tensor:
    """One unidirectional layer of ``rnn_type``: params {"wx", "wh",
    "b"}; x [T, B, F] -> [T, B, H]. ``recurrence`` computes the layer
    from direction-major inputs (``_recurrence``, or the column-parallel
    ``parallel.tp.TensorParallel.recurrence``)."""
    T, B, _ = x.shape
    lens = lengths.to(torch.int32)
    start = torch.zeros((1, B), dtype=torch.int32, device=x.device)
    out = recurrence(x[None], params["wx"][None], params["b"][None],
                     params["wh"][None], start, lens[None],
                     compute_dtype, use_kernel, rnn_type)
    return out[0]


def lstm_apply(params: dict, x: torch.Tensor, lengths: torch.Tensor,
               compute_dtype=torch.bfloat16,
               use_kernel: bool = False) -> torch.Tensor:
    """params {"wx", "wh", "b"}; x [T, B, F] -> [T, B, H]."""
    return rnn_apply(params, x, lengths, "lstm", compute_dtype, use_kernel)


def gru_apply(params: dict, x: torch.Tensor, lengths: torch.Tensor,
              compute_dtype=torch.bfloat16,
              use_kernel: bool = False) -> torch.Tensor:
    """params {"wx", "wh", "b"} with 3H gate columns r, z, n;
    x [T, B, F] -> [T, B, H]."""
    return rnn_apply(params, x, lengths, "gru", compute_dtype, use_kernel)


def vanilla_apply(params: dict, x: torch.Tensor, lengths: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """params {"wx", "wh", "b"} of width H; x [T, B, F] -> [T, B, H];
    ``h' = tanh(x @ wx + h @ wh + b)``."""
    return rnn_apply(params, x, lengths, "rnn", compute_dtype)


def birnn_apply(params: dict, x: torch.Tensor, lengths: torch.Tensor,
                compute_dtype=torch.bfloat16, use_kernel: bool = False,
                rnn_type: str = "lstm",
                recurrence=_recurrence) -> torch.Tensor:
    """params {"fwd": {...}, "bwd": {...}}; x [T, B, F] -> [T, B, 2H]
    (forward half, then the backward half in natural time); both
    directions go through one ``recurrence`` call (see ``rnn_apply``)."""
    T, B, _ = x.shape
    lens = lengths.to(torch.int32)
    start = torch.stack([torch.zeros_like(lens), T - lens])
    end = torch.stack([lens, torch.full_like(lens, T)])
    fwd, bwd = params["fwd"], params["bwd"]
    out = recurrence(torch.stack([x, torch.flip(x, (0,))]),
                     torch.stack([fwd["wx"], bwd["wx"]]),
                     torch.stack([fwd["b"], bwd["b"]]),
                     torch.stack([fwd["wh"], bwd["wh"]]),
                     start, end, compute_dtype, use_kernel, rnn_type)
    return torch.cat([out[0], torch.flip(out[1], (0,))], dim=-1)
