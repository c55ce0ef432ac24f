"""Primitive layers: dense, SAME conv2d, clipped ReLU.

Counterpart of ``ctc_asr_tpu/models/layers.py`` at inference (dropout
is train-only and left out). Parameters keep the reference's layouts:
dense ``w [in, out]``, conv ``w [kh, kw, cin, cout]`` (HWIO), and the
conv takes and returns NHWC ``[B, T, F, C]``. Operands are cast to the
compute dtype; results come back in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    """min(max(x, 0), clip) — the frontend nonlinearity."""
    return torch.clamp(x, 0.0, clip)
