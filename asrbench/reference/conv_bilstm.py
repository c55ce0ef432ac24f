"""The ``conv_bilstm`` family: the plain reference of the conv +
bidirectional-LSTM CTC model, in float32 with TF32 off (features,
encoder, CTC loss and the optimizer), its parameters' layout, its FLOP
count and its tiny cut. It is the family of a configuration that names
none (``asrbench/README.md`` gives the contract).

It is the model's math written down once more, with library calls and no
kernel of the port: the log-mel frontend by ``torch.fft.rfft``, the two
TF-SAME 2-D convs by ``torch.nn.functional.conv2d``, each bidirectional
layer by one packed ``LSTM`` call (gate order i, f, g, o; the backward
direction runs from each row's last valid frame, as the port's static
flip does), the CTC loss by ``torch.nn.functional.ctc_loss`` (blank the
last class, the mean over feasible rows), and global-norm clipping and
Adam as optax computes them. It imports neither the port nor JAX, and
takes from its caller only raw inputs: the int16 samples, their
lengths, the labels, the parameters' starting values and the
configuration's dict.

``quant="fp8"`` makes it the control: every operand of a matmul or conv
(activations and weights; the recurrent state excepted) rounded to
float8 e4m3 with a per-tensor scale, the accumulation in f32, as a
kernel in the next precision below bf16 would compute.
"""

from __future__ import annotations

import contextlib
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import _VF

from ..flops import num_frames

WIRE_SCALE = 32768.0
LOG_FLOOR = 1e-6
FP8_MAX = 448.0

# the harness's --tiny cut for its CPU tests: a narrow model and a small
# beam; never used on the chip
TINY_CONFIG = {"model": {"rnn_units": 16, "rnn_layers": 2,
                         "conv_channels": [4, 4]},
               "decode": {"beam_width": 8, "nbest": 4}}


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convs in full precision (no TF32), restored
    after."""
    cm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def quantize(x: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``x`` as the control's operand: unchanged, or through float8 e4m3
    with a per-tensor scale (amax to the format's largest finite value).
    The gradient passes straight through."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown quantization {quant!r}")
    scale = FP8_MAX / torch.clamp_min(x.detach().abs().amax(), 1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


# ---------------------------------------------------------------------------
# Parameters: the port's keys and layouts, and how a fresh model starts
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def param_shapes(cfg: dict) -> dict:
    """Every leaf's shape, in the order of the seeded draw, under the
    port's keys and layouts: ``frontend/<i>/w [kt, kf, cin, cout]``,
    ``frontend/<i>/b``, ``rnn/<i>/<fwd|bwd>/wx [d, 4H]``, ``wh [H, 4H]``,
    ``b [4H]``, ``head/w [d, C]``, ``head/b [C]``."""
    m, feat = cfg["model"], cfg["features"]
    F = feat["n_mfcc"] if feat["feature_type"] == "mfcc" else feat["n_mels"]
    out = {}
    cin, f = 1, F
    for i, (ch, (kt, kf), (_st, sf)) in enumerate(zip(
            m["conv_channels"], m["conv_kernels"], m["conv_strides"])):
        out[f"frontend/{i}/w"] = (kt, kf, cin, ch)
        out[f"frontend/{i}/b"] = (ch,)
        cin, f = ch, _cdiv(f, sf)
    d = f * cin
    G = {"lstm": 4, "gru": 3, "rnn": 1}[m["rnn_type"]] * m["rnn_units"]
    dirs = ("fwd/", "bwd/") if m["bidirectional"] else ("",)
    for i in range(m["rnn_layers"]):
        for p in dirs:
            out[f"rnn/{i}/{p}wx"] = (d, G)
            out[f"rnn/{i}/{p}wh"] = (m["rnn_units"], G)
            out[f"rnn/{i}/{p}b"] = (G,)
        d = len(dirs) * m["rnn_units"]
    out["head/w"] = (d, m["num_classes"])
    out["head/b"] = (m["num_classes"],)
    return out


def init_fixed(key: str, shape: tuple, cfg: dict,
               device) -> torch.Tensor | None:
    """A bias's starting value as a fresh model has it: zeros, and an
    LSTM's forget gate 1. None for a weight: the seeded Glorot draw fills
    it."""
    if not key.endswith("/b"):
        return None
    v = torch.zeros(shape, dtype=torch.float32, device=device)
    if key.startswith("rnn/") and cfg["model"]["rnn_type"] == "lstm":
        H = cfg["model"]["rnn_units"]
        v[H:2 * H] = 1.0
    return v


def shape_for_decode(params: dict, shaping: dict, cfg: dict) -> None:
    """The decode cells' parameters, in place: each LSTM driven mostly by
    its input (its input weights times ``wx_gain``, its forget-gate bias
    ``forget_bias``), so that posteriors change from frame to frame. The
    decode driver then calibrates the head."""
    H = cfg["model"]["rnn_units"]
    for k, v in params.items():
        if k.startswith("rnn/") and k.endswith("/wx"):
            v.mul_(shaping["wx_gain"])
        elif k.startswith("rnn/") and k.endswith("/b"):
            v[H:2 * H] = shaping["forget_bias"]


# ---------------------------------------------------------------------------
# Features: int16 wire samples -> per-utterance normalized log-mel
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_fft: int, n_mels: int, sample_rate: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Triangular HTK-scale filters [n_fft//2+1, n_mels]."""
    n_bins = n_fft // 2 + 1
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                n_mels + 2))
    freqs = np.arange(n_bins) * sample_rate / float(n_fft)
    fb = np.zeros((n_bins, n_mels), np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz[m], hz[m + 1], hz[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def features(samples: torch.Tensor, lengths: torch.Tensor, feat: dict):
    """[B, S] int16, [B] -> ([B, T, n_mels] f32, frame lengths [B])."""
    if feat["feature_type"] != "mel" or feat["normalization"] != "utterance":
        raise ValueError("the reference computes per-utterance log-mel only")
    sr = feat["sample_rate"]
    W = int(sr * feat["win_ms"] / 1000.0)
    hop = int(sr * feat["hop_ms"] / 1000.0)
    x = samples.to(torch.float32) / WIRE_SCALE
    frames = x.unfold(-1, W, hop)                          # [B, T, W]
    n = torch.arange(W, device=x.device, dtype=torch.float64)
    win = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / W)).float()
    spec = torch.fft.rfft(frames * win, n=feat["n_fft"])
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(mel_filterbank(feat["n_fft"], feat["n_mels"], sr,
                                        feat["fmin"], feat["fmax"]),
                         device=x.device)
    logmel = torch.log(torch.clamp_min(power @ fb, LOG_FLOOR))
    flens = torch.clamp_min(1 + torch.div(lengths.long() - W, hop,
                                          rounding_mode="floor"), 0)
    T = logmel.shape[1]
    mask = (torch.arange(T, device=x.device)[None, :] < flens[:, None])
    maskf = mask[..., None].float()
    cnt = torch.clamp_min(flens.float(), 1.0)[:, None, None]
    mean = (logmel * maskf).sum(1, keepdim=True) / cnt
    var = ((logmel - mean) ** 2 * maskf).sum(1, keepdim=True) / cnt
    return (logmel - mean) * torch.rsqrt(var + 1e-8) * maskf, flens


# ---------------------------------------------------------------------------
# Encoder: TF-SAME convs, clipped ReLU, bidirectional LSTMs, dense head
# ---------------------------------------------------------------------------

def _same(in_size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return total // 2, total - total // 2


def _bilstm(x: torch.Tensor, lens: torch.Tensor, p: dict, prefix: str,
            quant: str | None) -> torch.Tensor:
    """One bidirectional layer on time-major [T, B, D] -> [T, B, 2H]."""
    T = x.shape[0]
    flat = []
    for d in ("fwd", "bwd"):
        wx, wh, b = (p[f"{prefix}{d}/{k}"] for k in ("wx", "wh", "b"))
        flat += [quantize(wx, quant).t().contiguous(),
                 quantize(wh, quant).t().contiguous(), b,
                 torch.zeros_like(b)]
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        quantize(x, quant), lens.cpu(), enforce_sorted=False)
    H = p[f"{prefix}fwd/wh"].shape[0]
    B = x.shape[1]
    h0 = x.new_zeros(2, B, H)
    with warnings.catch_warnings():
        # the weights are separate tensors, not one cuDNN buffer
        warnings.simplefilter("ignore", UserWarning)
        out = _VF.lstm(packed.data, packed.batch_sizes, (h0, h0), flat,
                       True, 1, 0.0, True, True)[0]
    packed_out = torch.nn.utils.rnn.PackedSequence(
        out, packed.batch_sizes, packed.sorted_indices,
        packed.unsorted_indices)
    y, _ = torch.nn.utils.rnn.pad_packed_sequence(packed_out,
                                                  total_length=T)
    return y


def encoder(params: dict, feats: torch.Tensor, flens: torch.Tensor,
            model: dict, quant: str | None = None):
    """[B, T, F] features -> (logits [B, T', C] f32, lengths [B])."""
    if model["frontend"] != "conv" or model["rnn_type"] != "lstm" \
            or not model["bidirectional"]:
        raise ValueError(
            "the conv_bilstm family computes the conv frontend + "
            "bidirectional LSTM model only; another model names its own "
            "\"family\" in its configuration file")
    x = feats[:, None]                                   # [B, 1, T, F]
    lens = flens.long()
    for i, (st, sf) in enumerate(model["conv_strides"]):
        w = params[f"frontend/{i}/w"]                    # [kt, kf, ci, co]
        kt, kf = w.shape[:2]
        t_lo, t_hi = _same(x.shape[2], kt, st)
        f_lo, f_hi = _same(x.shape[3], kf, sf)
        x = F.conv2d(F.pad(quantize(x, quant), (f_lo, f_hi, t_lo, t_hi)),
                     quantize(w, quant).permute(3, 2, 0, 1), stride=(st, sf))
        x = x + params[f"frontend/{i}/b"][None, :, None, None]
        x = torch.clamp(x, 0.0, model["relu_clip"])
        lens = -(-lens // st)
    B, C, Tp, Fp = x.shape
    x = x.permute(2, 0, 3, 1).reshape(Tp, B, Fp * C)     # NHWC flatten
    valid = torch.arange(Tp, device=x.device)[:, None] < lens[None, :]
    x = x * valid[..., None].float()
    for i in range(model["rnn_layers"]):
        x = _bilstm(x, lens, params, f"rnn/{i}/", quant)
    logits = quantize(x, quant) @ quantize(params["head/w"], quant) \
        + params["head/b"]
    return logits.transpose(0, 1), lens


def ctc_nll(logits: torch.Tensor, lens: torch.Tensor, labels: torch.Tensor,
            label_lens: torch.Tensor) -> torch.Tensor:
    """Per-row CTC negative log-likelihood [B]; +inf where no alignment
    fits. Blank is the last class."""
    lp = torch.log_softmax(logits.float(), -1).transpose(0, 1)
    return F.ctc_loss(lp, labels.long(), lens.long(), label_lens.long(),
                      blank=logits.shape[-1] - 1, reduction="none",
                      zero_infinity=False)


def ctc_mean_loss(nll: torch.Tensor) -> torch.Tensor:
    """The mean over feasible rows (an infeasible row counts 0)."""
    finite = torch.isfinite(nll)
    return torch.where(finite, nll, torch.zeros_like(nll)).sum() \
        / torch.clamp_min(finite.float().sum(), 1.0)


def forward_loss(params, batch: dict, cfg: dict, quant=None):
    feats, flens = features(batch["samples"], batch["sample_lengths"],
                            cfg["features"])
    logits, lens = encoder(params, feats, flens, cfg["model"], quant)
    nll = ctc_nll(logits, lens, batch["labels"], batch["label_lengths"])
    return ctc_mean_loss(nll)


# ---------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adam)
# ---------------------------------------------------------------------------

@torch.no_grad()
def adam_step(params: dict, grads: dict, state: dict, tcfg: dict) -> dict:
    """One clipped Adam update in place; returns the clipped gradients
    (the gradients as the optimizer takes them)."""
    gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())
                       ).float()
    if tcfg["grad_clip_norm"] > 0 and gnorm >= tcfg["grad_clip_norm"]:
        grads = {k: g / gnorm * tcfg["grad_clip_norm"]
                 for k, g in grads.items()}
    if tcfg["lr_schedule"] != "constant" or tcfg["weight_decay"] != 0:
        raise ValueError("the reference optimizer is constant-rate Adam")
    b1, b2, eps, lr = (tcfg["adam_b1"], tcfg["adam_b2"], tcfg["adam_eps"],
                       tcfg["learning_rate"])
    state["count"] += 1
    k = np.float32(state["count"])
    bc1 = float(np.float32(1.0) - np.float32(b1) ** k)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** k)
    for key, p in params.items():
        g = grads[key]
        mu = state["mu"][key].mul_(b1).add_((1.0 - b1) * g)
        nu = state["nu"][key].mul_(b2).add_((1.0 - b2) * g * g)
        p.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))
    return grads


def train_steps(params0: dict, batches: list, cfg: dict, quant=None,
                rows=None) -> dict:
    """Train steps from ``params0`` (not changed), one a batch:
    ``{"losses": [...], "grads1": clipped gradients of the first step,
    "params": the parameters after the last}``. ``rows`` keeps only
    those rows of each batch (a fault that drops part of the batch)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    state = {"count": 0,
             "mu": {k: torch.zeros_like(v) for k, v in params0.items()},
             "nu": {k: torch.zeros_like(v) for k, v in params0.items()}}
    losses, grads1 = [], None
    with exact_f32():
        for batch in batches:
            if rows is not None:
                batch = {k: v[rows] for k, v in batch.items()}
            loss = forward_loss(params, batch, cfg, quant)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            clipped = adam_step(params, grads, state, cfg["train"])
            losses.append(float(loss.detach()))
            if grads1 is None:
                grads1 = {k: v.detach() for k, v in clipped.items()}
            del loss, grads, clipped
    return {"losses": losses, "grads1": grads1,
            "params": {k: v.detach() for k, v in params.items()}}


@torch.no_grad()
def logits(params: dict, samples: torch.Tensor, lengths: torch.Tensor,
           cfg: dict, quant=None):
    """Decode side: int16 samples [B, S] and their lengths [B] ->
    (logits [B, T', C] f32, lengths [B])."""
    with exact_f32():
        feats, flens = features(samples, lengths, cfg["features"])
        return encoder(params, feats, flens, cfg["model"], quant)


@torch.no_grad()
def log_probs(params: dict, batch: dict, cfg: dict, quant=None):
    """Decode side: (log-posteriors [B, T', C] f32, lengths [B])."""
    out, lens = logits(params, batch["samples"], batch["sample_lengths"],
                       cfg, quant)
    return torch.log_softmax(out.float(), -1), lens


# ---------------------------------------------------------------------------
# Work: encoder frames and the step's algorithmic FLOPs
# ---------------------------------------------------------------------------

def encoder_frames(n_samples: int, cfg: dict) -> int:
    """Encoder output frames of an utterance of ``n_samples`` samples:
    each strided SAME conv maps L -> ceil(L / s) on the time axis."""
    t = num_frames(n_samples, cfg["features"])
    if cfg["model"]["frontend"] == "conv":
        for st, _ in cfg["model"]["conv_strides"]:
            t = _cdiv(t, st)
    return t


def step_flops(cfg: dict, batch: int, seconds: float) -> float:
    """Analytic ALGORITHMIC matmul FLOPs of one train step (fwd ~x3 for
    fwd+bwd, the standard MFU convention — counts the math the model
    defines, not the banded/padded formulation actually executed).
    Elementwise/DSP work is excluded (<2% of the dot FLOPs here). A frozen
    copy of the repository's ``bench.py`` ``model_step_flops``."""
    fcfg, m = cfg["features"], cfg["model"]
    T = int(seconds * 1000 / fcfg["hop_ms"])          # feature frames
    F = fcfg["n_mfcc"] if fcfg["feature_type"] == "mfcc" else fcfg["n_mels"]
    fwd = 0.0
    if m["frontend"] == "conv":
        t, f, cin = T, F, 1
        for ch, (kt, kf), (st, sf) in zip(m["conv_channels"],
                                          m["conv_kernels"],
                                          m["conv_strides"]):
            t, f = -(-t // st), -(-f // sf)
            fwd += 2.0 * t * f * ch * kt * kf * cin
            cin = ch
        d, Tp = f * cin, t
    else:
        d, Tp = F, T
        for _ in range(m["dense_layers"]):
            fwd += 2.0 * Tp * d * m["dense_units"]
            d = m["dense_units"]
    H = m["rnn_units"]
    gates = {"lstm": 4, "gru": 3, "rnn": 1}[m["rnn_type"]]
    nd = 2 if m["bidirectional"] else 1
    for _ in range(m["rnn_layers"]):
        fwd += nd * 2.0 * Tp * (d * gates * H + H * gates * H)
        d = nd * H
    fwd += 2.0 * Tp * d * m["num_classes"]
    return 3.0 * fwd * batch
