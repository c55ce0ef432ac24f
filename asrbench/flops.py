"""The yardstick's arithmetic: the H100's published peaks, the least time
a piece of work could take on it, and a window's share of the peak.

Frozen copies, so that a change to the program cannot move the ruler:
``bound``, ``lstm_bounds``, ``beam_bound`` and ``conv_flops`` from
``chip_smoke.py`` (``bound``, ``_lstm_bounds``, ``_beam_bound``,
``_conv_flops``). The model's geometry comes from the configuration's
dict (``configs/<name>.json``), never from the program's config classes;
a model's own work (its FLOPs a step, its encoder frames) is counted by
its family (``reference/<family>.py``), which the run carries.
"""

from __future__ import annotations

import math

# Published peaks of one H100 SXM at its 700 W limit: HBM3 bytes/s, dense
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations
    at their type's peak rate, whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = n_ops / peak_ops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def num_frames(n_samples: int, feat: dict) -> int:
    """Feature frames of ``n_samples`` samples: 25 ms windows at a 10 ms
    hop, no centering."""
    win = int(feat["sample_rate"] * feat["win_ms"] / 1000.0)
    hop = int(feat["sample_rate"] * feat["hop_ms"] / 1000.0)
    return 0 if n_samples < win else 1 + (n_samples - win) // hop


def lstm_bounds(nd: int, T: int, B: int, H: int) -> tuple[dict, dict]:
    """K2: xproj read, h written (bf16), wh read once; 2*B*H*4H FLOPs a
    step and direction on the tensor cores. K3: g_out, gates and c read,
    dxproj written; the same FLOPs for dgates @ wh^T."""
    flops = 2.0 * nd * T * B * H * 4 * H
    cell = 2 * nd * T * B * H                       # bytes of one bf16 [.., H]
    wh = 2 * nd * H * 4 * H
    return (bound(4 * cell + cell + wh, flops, PEAK_BF16),
            bound(cell + 4 * cell + cell + 4 * cell + wh, flops, PEAK_BF16))


def beam_bound(lens, B: int, K: int, C: int, U: int, kout: int,
               table_bytes: float) -> dict:
    """K8 on this run's data, counting what the function needs and not
    what this kernel does. Bytes: each valid frame's C log-probs and the
    lengths read once; the LM table at most once (one row of C-1 floats
    per beam and frame where that is less); the ids, lengths and scores
    written once. The back-pointer scratch is neither input nor output
    and is not counted. Operations per valid frame, at the f32 / integer
    rate outside the tensor cores: ~12 for each of the K*C candidates
    (adds, a compare, the LM and bonus terms, the hash), 4 for each of
    the K*K merge tests, and a selection of the K best that is linear
    in the candidates (2 each), not a full sort."""
    frames = float(sum(int(n) for n in lens))
    ops = frames * (12 * K * C + 4 * K * K + 2 * K * C)
    lm_rows = 4.0 * (C - 1) * K * frames
    n_bytes = (4 * C * frames + 4 * B + min(table_bytes, lm_rows)
               + 4 * B * kout * (U + 2))
    return bound(n_bytes, ops, PEAK_F32)


def _pick_gfo(f_out: int, cout: int):
    """Smallest output-freq group with f_out % gfo == 0 and a full
    128-column tile (gfo*cout % 128 == 0); None = no such tiling."""
    for gfo in range(1, f_out + 1):
        if f_out % gfo == 0 and (gfo * cout) % 128 == 0:
            return gfo
    return None


def conv_flops(form: str, w_shape, B: int, T_out: int, F_in: int,
               sf: int) -> float:
    """Multiply-adds x 2 of one conv's forward in ``form``: the true 2-D
    conv, the full band (every input row against every output column) or
    the blocked band (each block's slab against its gfo columns; the
    full band where no 128-column tiling exists)."""
    kt, kf, cin, cout = w_shape
    f_out = _cdiv(F_in, sf)
    gfo = _pick_gfo(f_out, cout)
    if form == "2-D":
        k, n = kt * kf * cin, f_out * cout
    elif form == "full band" or gfo is None:
        k, n = kt * F_in * cin, f_out * cout
    else:
        k = kt * min((gfo - 1) * sf + kf, F_in) * cin
        n = f_out * cout
    return 2.0 * B * T_out * k * n


def frontend_bound(cfg: dict, B: int, T: int, form: str = "2-D") -> dict:
    """The conv frontend's forward and backward of one [B, T, F] batch of
    features: the first conv's forward and weight gradient (its input
    wants no gradient), every later conv's forward, input and weight
    gradients (``chip_smoke.phase_conv``: 2 f1 + 3 f2). Bytes: the
    features, the last conv's output and every leaf in f32, twice, and
    the output's cotangent once. The algorithm's work is the true 2-D
    conv's, whatever form the program takes."""
    m, feat = cfg["model"], cfg["features"]
    F = feat["n_mfcc"] if feat["feature_type"] == "mfcc" else feat["n_mels"]
    t, f, cin = T, F, 1
    flops, leaves = 0.0, 0
    for i, (ch, (kt, kf), (st, sf)) in enumerate(zip(
            m["conv_channels"], m["conv_kernels"], m["conv_strides"])):
        t_out = _cdiv(t, st)
        fwd = conv_flops(form, (kt, kf, cin, ch), B, t_out, f, sf)
        flops += (2 if i == 0 else 3) * fwd
        leaves += kt * kf * cin * ch + ch
        t, f, cin = t_out, _cdiv(f, sf), ch
    io = 4 * (B * T * F + B * t * f * cin + leaves)
    return bound(2 * io + 4 * B * t * f * cin, flops, PEAK_BF16)


def window_mfu(family, records, cfg: dict, wall: float, sr: int,
               fwd_only: bool) -> float:
    """Algorithmic FLOPs of the records' unpadded rows (``family``'s
    ``step_flops``) over the wall time at the bf16 peak, in %."""
    work = sum(family.step_flops(cfg, 1, n / sr)
               for r in records for n in r["lengths"])
    if fwd_only:
        work /= 3.0
    return 100.0 * work / (wall * PEAK_BF16) if wall > 0 else math.nan
