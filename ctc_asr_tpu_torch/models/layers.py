"""Primitive layers: Glorot init, dense, SAME conv2d, clipped ReLU,
dropout.

Counterpart of ``ctc_asr_tpu/models/layers.py``. Randomness (init,
dropout) comes from an explicit ``torch.Generator``: torch cannot
reproduce JAX's PRNG streams, so the tests compare with dropout 0 or
check the keep rate and scale. Parameters keep the reference's layouts:
dense ``w [in, out]``, conv ``w [kh, kw, cin, cout]`` (HWIO), and the
conv takes and returns NHWC ``[B, T, F, C]``. Operands are cast to the
compute dtype; results come back in float32.
"""

from __future__ import annotations

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
