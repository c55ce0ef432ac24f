"""Primitive layers: Glorot init, dense, SAME conv2d (as a 2-D conv, or
as a 1-D time conv over banded matrices, full or in frequency blocks),
clipped ReLU, dropout.

Counterpart of ``ctc_asr_tpu/models/layers.py``. Randomness (init,
dropout) comes from an explicit ``torch.Generator``: torch cannot
reproduce JAX's PRNG streams, so the tests compare with dropout 0 or
check the keep rate and scale. Parameters keep the reference's layouts:
dense ``w [in, out]``, conv ``w [kh, kw, cin, cout]`` (HWIO), and the
conv takes and returns NHWC ``[B, T, F, C]``. Operands are cast to the
compute dtype; results come back in float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def glorot(shape, generator: torch.Generator) -> torch.Tensor:
    """Glorot-uniform f32 on the CPU (``layers.glorot``): conv kernels
    multiply both fans by the receptive field."""
    fan_in, fan_out = shape[-2], shape[-1]
    if len(shape) > 2:
        rf = int(np.prod(shape[:-2]))
        fan_in, fan_out = fan_in * rf, fan_out * rf
    scale = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * 2.0 - 1.0) * scale


def dense_apply(params: dict, x: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ w + b with operands rounded to the compute dtype and the
    product accumulated and returned in float32."""
    w = params["w"].to(compute_dtype).float()
    return x.to(compute_dtype).float() @ w + params["b"]


def same_pad(in_size: int, k: int, s: int) -> tuple[int, int, int]:
    """TF-SAME geometry: (out size, pad before, pad after). The extra
    pad goes AFTER: a symmetric padding has the same output shape but
    shifts every strided window."""
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return out, total // 2, total - total // 2


def conv2d_apply(params: dict, x: torch.Tensor, strides,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """NHWC conv with TF-SAME padding; x [B, T, F, Cin] -> [B, T', F',
    Cout] f32. The conv runs in the compute dtype (its output rounded
    to it, as in the reference), then the bias is added in f32."""
    kt, kf = params["w"].shape[:2]
    st, sf = strides
    _, t_lo, t_hi = same_pad(x.shape[1], kt, st)
    _, f_lo, f_hi = same_pad(x.shape[2], kf, sf)
    xc = F.pad(x.permute(0, 3, 1, 2).to(compute_dtype),
               (f_lo, f_hi, t_lo, t_hi))
    w = params["w"].permute(3, 2, 0, 1).to(compute_dtype)   # OIHW
    y = F.conv2d(xc, w, stride=(st, sf))
    return y.permute(0, 2, 3, 1).float() + params["b"]


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms, and no ``cudnn.benchmark``, for
    the convs run inside (a train step's forward and backward), restored
    after. Without it cuDNN may take a weight-gradient algorithm that
    sums with atomics, and one seed no longer gives one run."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old


# ---------------------------------------------------------------------------
# The conv as a banded matmul (``ctc_asr_tpu/models/layers.py:77-209``).
# The frontend convs have 1 and 32 channels; folding the FREQUENCY kernel
# into a banded matrix [F*cin -> f_out*cout] (one shifted copy of the
# kernel per output-frequency column, zero elsewhere) turns the 2-D conv
# into a 1-D TIME conv over wide channels (80 -> 1280 and 1280 -> 640 at
# the DS2 shapes), the shape tensor cores want. The blocked form groups
# the output columns by ``gfo`` (gfo*cout = 128) so that each block
# contracts only its receptive slab of input rows. The time conv stays a
# library call, as the reference leaves it to XLA; the band matrices are
# built from the HWIO kernel at each call, and gradients flow through
# that construction by autograd (the reference measured a custom backward
# and rejected it).
# ---------------------------------------------------------------------------

def _band_matrices(w: torch.Tensor, F_in: int, sf: int) -> torch.Tensor:
    """[kt, kf, cin, cout] -> per-time-tap banded [kt, F*cin, f_out*cout]:
    column fo holds the kernel's taps at input rows fo*sf - pad + [0, kf),
    zeros elsewhere. Built as windows of F rows at stride sf over the
    frequency-flipped kernel between zeros (window fo is column fo, last
    row first), so that autograd sums each tap's gradient by a fixed
    order (a gather's backward accumulates in any order)."""
    kt, kf, cin, cout = w.shape
    f_out, pf_lo, _ = same_pad(F_in, kf, sf)
    lead = F_in + pf_lo - kf              # negative pads crop
    trail = (f_out - 1) * sf + F_in - lead - kf
    wz = F.pad(w.flip(1), (0, 0, 0, 0, lead, trail))
    band = wz.unfold(1, F_in, sf).flip(-1)   # [kt, fo, cin, cout, F]
    return band.permute(0, 4, 2, 1, 3).reshape(kt, F_in * cin, f_out * cout)


def _time_conv(x: torch.Tensor, w: torch.Tensor, st: int) -> torch.Tensor:
    """TF-SAME 1-D conv over time: x [B, T, D] contiguous, w [O, D, kt] ->
    [B, T', O], in their dtype. Run as a 2-D conv over [B, D, T, 1]
    in the channels-last layout, which is x's own, so cuDNN takes the
    activations as they lie and its output [B, O, T', 1] is [B, T', O]."""
    B, T, D = x.shape
    T_out, lo, hi = same_pad(T, w.shape[2], st)
    if lo != hi:
        x, lo = F.pad(x, (0, 0, lo, hi)), 0
    x4 = x.unsqueeze(2).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    w4 = w.unsqueeze(3).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x4, w4, stride=(st, 1), padding=(lo, 0))
    return y.permute(0, 2, 3, 1).reshape(B, T_out, -1)


def conv2d_matmul_apply(params: dict, x: torch.Tensor, strides,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``conv2d_apply`` (NHWC, TF-SAME) as a 1-D banded conv over time:
    x [B, T, F, Cin] -> [B, T', F', Cout] f32."""
    w = params["w"]
    cout = w.shape[3]
    B, T, F_in, C = x.shape
    st, sf = strides
    Wb = _band_matrices(w, F_in, sf)                  # [kt, F*cin, fo*co]
    wt = Wb.permute(2, 0, 1).to(compute_dtype,         # [O, kt, D] in memory
                                memory_format=torch.contiguous_format)
    y = _time_conv(x.reshape(B, T, F_in * C).to(compute_dtype),
                   wt.permute(0, 2, 1), st)
    return y.float().reshape(B, y.shape[1], -1, cout) + params["b"]


def _pick_gfo(f_out: int, cout: int):
    """Smallest output-freq group with f_out % gfo == 0 and a full
    128-column tile (gfo*cout % 128 == 0); None = no such tiling."""
    for gfo in range(1, f_out + 1):
        if f_out % gfo == 0 and (gfo * cout) % 128 == 0:
            return gfo
    return None


def _blocked_bands(w: torch.Tensor, F_in: int, sf: int, gfo: int):
    """Per-block slab starts (ints) and band matrices: block g computes
    output freq columns [g*gfo, (g+1)*gfo) from input rows [starts[g],
    starts[g] + gin_f) through matrix g [kt, gin_f*cin, gfo*cout], a view
    into the full band."""
    kt, kf, cin, cout = w.shape
    f_out, pf_lo, _ = same_pad(F_in, kf, sf)
    gin_f = min((gfo - 1) * sf + kf, F_in)
    Wb = _band_matrices(w, F_in, sf).reshape(kt, F_in, cin, f_out * cout)
    starts = [max(0, min(g * gfo * sf - pf_lo, F_in - gin_f))
              for g in range(f_out // gfo)]
    mats = [Wb[:, s:s + gin_f, :, g * gfo * cout:(g + 1) * gfo * cout]
            .reshape(kt, gin_f * cin, gfo * cout)
            for g, s in enumerate(starts)]
    return starts, mats


def _conv_blocked_fwd_impl(w, b, x, strides, compute_dtype):
    """The blocked banded conv: one 1-D time conv a distinct input slab.
    Blocks whose slabs start at the same row (the clamped ones at either
    edge) share one conv, their band matrices side by side; the outputs
    concatenate in block order (the starts never decrease), as the
    reference's one conv a block does."""
    kt, kf, cin, cout = w.shape
    B, T, F_in, C = x.shape
    st, sf = strides
    f_out = same_pad(F_in, kf, sf)[0]
    starts, mats = _blocked_bands(w, F_in, sf, _pick_gfo(f_out, cout))
    K = mats[0].shape[1]
    xb = x.to(compute_dtype)
    outs = []
    for s in sorted(set(starts)):
        # [O, kt, K] in memory: the layout _time_conv gives cuDNN
        wt = torch.cat([m.permute(2, 0, 1) for m, t in zip(mats, starts)
                        if t == s]).to(compute_dtype)
        slab = xb[:, :, s:s + K // cin].reshape(B, T, K)
        outs.append(_time_conv(slab, wt.permute(0, 2, 1), st))
    y = torch.cat(outs, -1)
    return y.float().reshape(B, y.shape[1], f_out, cout) + b


def conv2d_blocked_apply(params: dict, x: torch.Tensor, strides,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``conv2d_matmul_apply`` in the blocked form where a 128-column
    output-freq tiling exists, and the full band otherwise (part of the
    reference's function, not a fallback of the device)."""
    kt, kf, cin, cout = params["w"].shape
    f_out = same_pad(x.shape[2], kf, strides[1])[0]
    if _pick_gfo(f_out, cout) is None:
        return conv2d_matmul_apply(params, x, strides, compute_dtype)
    return _conv_blocked_fwd_impl(params["w"], params["b"], x,
                                  tuple(strides), compute_dtype)


def clipped_relu(x: torch.Tensor, clip: float = 20.0) -> torch.Tensor:
    """min(max(x, 0), clip) — the frontend nonlinearity. Written with
    maximum/minimum, whose gradient splits a tie in half as ``jnp.clip``'s
    does (``torch.clamp`` passes all of it): a conv output is exactly 0
    wherever its window holds only padding."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                         torch.full_like(x, clip))


def dropout_mask(shape, rate: float, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """Bool keep-mask with P(keep) = 1 - rate, drawn from ``generator``
    (which lies on ``device``)."""
    return torch.rand(shape, generator=generator, device=device) \
        < 1.0 - rate


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None = None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the kept ones
    by 1/(1-rate) (``layers.dropout``). The mask is drawn from
    ``generator`` unless given (a rematerialized layer draws it outside,
    so its recomputation sees the same one)."""
    if rate <= 0.0:
        return x
    if mask is None:
        mask = dropout_mask(x.shape, rate, generator, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x)
                       ).to(x.dtype)
