"""The ``conformer`` family: the plain reference of Conformer-CTC (Gulati
et al., arXiv:2005.08100) as NVIDIA NeMo's ``ConformerEncoder`` computes
it with ``self_attention_model: rel_pos`` (``examples/asr/conf/conformer/
conformer_ctc_char.yaml``), in float32 with TF32 off, its parameters'
layout, its work and its tiny cut (``asrbench/README.md`` gives the
contract).

It is the model written down once more from NeMo's modules, with library
calls and no code of the port: ``ConvSubsampling`` ("striding": two
Conv2d(3x3, stride 2, pad 1) + ReLU, then Linear), ``RelPositionalEncoding``
(x * sqrt(d_model), sinusoidal embeddings of the positions T-1 ...
-(T-1)), and per ``ConformerLayer``: x += FFN1(LN x) / 2; x +=
RelPositionMultiHeadAttention(LN x); x += ConformerConvolution(LN x); x
+= FFN2(LN x) / 2; x = LN x. The attention is NeMo's: (q + u) k^T plus
the relative shift of (q + v) p^T by NeMo's pad-and-reshape, over
sqrt(d_k), the mask of every (query, key) pair with a padded side filled
with -10000, softmax, the masked weights set to 0, the weighted sum,
the output linear. The conv module: pointwise conv -> GLU -> padded
frames 0 -> depthwise conv -> BatchNorm -> Swish -> pointwise conv. The
features, the CTC loss and the float8 control's rounding are
``conv_bilstm``'s; the optimizer is global-norm clipping and AdamW as
optax computes them.

Where it departs from NeMo, and why:

- the features are the port's (the ``conv_bilstm`` family's log-mel: 80
  bins, 25 / 10 ms, n_fft 512, per-utterance normalisation, no
  pre-emphasis and no dither), as NeMo's preprocessor settings are
  otherwise;
- the subsampling's linear takes each frame's (F', channels) values in
  that order (NeMo flattens channels first): the same model under a
  permutation of the weight's rows, so that the port's channels-last
  convs flatten for free;
- BatchNorm normalises by the batch's statistics over every frame of the
  padded batch in training, as ``nn.BatchNorm1d`` does in NeMo; the
  reference keeps no running statistics in ``train_steps``, which do not
  change a train step's result. ``logits`` and ``log_probs`` normalise
  by those under ``layers/<i>/conv/bn/mean`` and ``.../var`` in
  ``params`` where given, else by a fresh model's (mean 0, variance 1);
- dropout is 0 and SpecAugment off (the configuration's ``assumed``):
  the program's masks come from its own generator;
- starting values: Glorot-uniform weights from the harness's one seeded
  draw, LayerNorm and BatchNorm scales 1, every bias and u, v 0
  (``init_fixed``).

It imports neither the port nor JAX. On the card ``train_steps``
recomputes each layer in its backward (``torch.utils.checkpoint``), so
that f32 at B=64 fits; it never splits the batch, which BatchNorm
couples.

``quant="fp8"`` makes it the control: every operand of a matmul or conv
(activations and weights, the attention's too) rounded to float8 e4m3
with a per-tensor scale, the accumulation in f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..flops import num_frames
from .conv_bilstm import (ctc_mean_loss, ctc_nll, exact_f32, features,
                          quantize)

MASK_FILL = -10000.0
LN_EPS = 1e-5

# the harness's --tiny cut for its CPU tests: a narrow, shallow model;
# never used on the chip
TINY_CONFIG = {"model": {"d_model": 16, "n_heads": 2, "n_layers": 2,
                         "conv_kernel": 5, "subsampling_channels": 4}}


# ---------------------------------------------------------------------------
# Parameters: the port's keys and layouts, and how a fresh model starts
# ---------------------------------------------------------------------------

def _stages(m: dict) -> int:
    return int(round(math.log2(m["subsampling_factor"])))


def _feat_dim(cfg: dict) -> int:
    f = cfg["features"]
    return f["n_mfcc"] if f["feature_type"] == "mfcc" else f["n_mels"]


def param_shapes(cfg: dict) -> dict:
    """Every leaf's shape, in the order of the seeded draw, under the
    port's keys and layouts: dense ``w [in, out]``, the subsampling convs
    ``w [3, 3, cin, cout]``, the depthwise conv ``w [k, 1, d]``, u and v
    ``[heads, d_k]``."""
    m = cfg["model"]
    d, C, H = m["d_model"], m["subsampling_channels"], m["n_heads"]
    out = {}
    cin, f = 1, _feat_dim(cfg)
    for i in range(_stages(m)):
        out[f"subsampling/{i}/w"] = (3, 3, cin, C)
        out[f"subsampling/{i}/b"] = (C,)
        cin, f = C, (f - 1) // 2 + 1
    out["subsampling/out/w"] = (f * C, d)
    out["subsampling/out/b"] = (d,)
    if not m["untie_biases"]:
        out["pos_u"] = out["pos_v"] = (H, d // H)
    ff = m["ff_expansion"] * d
    for i in range(m["n_layers"]):
        p = f"layers/{i}/"
        for n in ("ff1", "att", "conv", "ff2", "out"):
            out[f"{p}{n}/ln/scale"] = out[f"{p}{n}/ln/bias"] = (d,)
        for n in ("ff1", "ff2"):
            out[f"{p}{n}/in/w"], out[f"{p}{n}/in/b"] = (d, ff), (ff,)
            out[f"{p}{n}/out/w"], out[f"{p}{n}/out/b"] = (ff, d), (d,)
        for n in ("q", "k", "v", "o"):
            out[f"{p}att/{n}/w"], out[f"{p}att/{n}/b"] = (d, d), (d,)
        out[f"{p}att/pos/w"] = (d, d)
        if m["untie_biases"]:
            out[f"{p}att/pos_u"] = out[f"{p}att/pos_v"] = (H, d // H)
        out[f"{p}conv/pw1/w"], out[f"{p}conv/pw1/b"] = (d, 2 * d), (2 * d,)
        out[f"{p}conv/dw/w"], out[f"{p}conv/dw/b"] = \
            (m["conv_kernel"], 1, d), (d,)
        out[f"{p}conv/bn/scale"] = out[f"{p}conv/bn/bias"] = (d,)
        out[f"{p}conv/pw2/w"], out[f"{p}conv/pw2/b"] = (d, d), (d,)
    out["head/w"] = (d, m["num_classes"])
    out["head/b"] = (m["num_classes"],)
    return out


def init_fixed(key: str, shape: tuple, cfg: dict,
               device) -> torch.Tensor | None:
    """LayerNorm and BatchNorm scales 1; their biases, every other bias,
    u and v 0; None for a weight: the seeded Glorot draw fills it."""
    if key.endswith("/scale"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    if key.endswith(("/b", "/bias", "pos_u", "pos_v")):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return None


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _linear(x, p: dict, name: str, quant):
    return quantize(x, quant) @ quantize(p[f"{name}/w"], quant) \
        + p[f"{name}/b"]


def _layer_norm(x, p: dict, name: str, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p[f"{name}/scale"] \
        + p[f"{name}/bias"]


def _swish(x):
    return x * torch.sigmoid(x)


def subsampled_lengths(flens: torch.Tensor, m: dict) -> torch.Tensor:
    """NeMo's ``calc_length`` for "striding": (L + 2 - 3) // 2 + 1 a
    stage."""
    lens = flens.long()
    for _ in range(_stages(m)):
        lens = torch.div(lens + 2 - 3, 2, rounding_mode="floor") + 1
    return lens


def positional_embeddings(T: int, d: int, device) -> torch.Tensor:
    """NeMo's ``RelPositionalEncoding``: [2T - 1, d] at positions T-1 down
    to -(T-1), sin at even columns and cos at odd ones."""
    positions = torch.arange(T - 1, -T, -1, dtype=torch.float32,
                             device=device).unsqueeze(1)
    div_term = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                      device=device)
                         * -(math.log(10000.0) / d))
    pe = torch.zeros(2 * T - 1, d, device=device)
    pe[:, 0::2] = torch.sin(positions * div_term)
    pe[:, 1::2] = torch.cos(positions * div_term)
    return pe


def nemo_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """NeMo's ``rel_shift``: [b, h, t1, t2] -> the same shape, row i moved
    left by t1 - 1 - i (pad a column, view, drop the first row)."""
    b, h, qlen, pos_len = x.size()
    x = F.pad(x, pad=(1, 0))
    x = x.view(b, h, -1, qlen)
    return x[:, :, 1:].reshape(b, h, qlen, pos_len)


def _attention(x, p: dict, pos, mask, uv, m: dict, quant):
    B, T, d = x.shape
    H = m["n_heads"]
    dk = d // H

    def heads(y):
        return y.view(B, -1, H, dk).transpose(1, 2)

    q = heads(_linear(x, p, "q", quant))
    k = heads(_linear(x, p, "k", quant))
    v = heads(_linear(x, p, "v", quant))
    pp = (quantize(pos, quant) @ quantize(p["pos/w"], quant)).view(
        1, -1, H, dk).transpose(1, 2)                     # [1, H, 2T-1, dk]
    u, vb = uv
    qu = q + u[None, :, None, :]
    qv = q + vb[None, :, None, :]
    ac = quantize(qu, quant) @ quantize(k, quant).transpose(-2, -1)
    bd = quantize(qv, quant) @ quantize(pp, quant).transpose(-2, -1)
    bd = nemo_rel_shift(bd)[:, :, :, :T]
    scores = (ac + bd) / math.sqrt(dk)
    scores = scores.masked_fill(mask, MASK_FILL)
    attn = torch.softmax(scores, dim=-1).masked_fill(mask, 0.0)
    o = quantize(attn, quant) @ quantize(v, quant)
    return _linear(o.transpose(1, 2).reshape(B, T, d), p, "o", quant)


def _batch_norm(x, p: dict, stats, m: dict):
    """x [B, T, d]: the batch's statistics over (B, T) where ``stats`` is
    None, else the running (mean, var)."""
    if stats is None:
        mean = x.mean((0, 1))
        var = ((x - mean) ** 2).mean((0, 1))
    else:
        mean, var = stats
    return (x - mean) / torch.sqrt(var + m["bn_eps"]) * p["bn/scale"] \
        + p["bn/bias"]


def _conv_module(x, p: dict, pad, stats, m: dict, quant):
    d = x.shape[-1]
    h = F.glu(_linear(x, p, "pw1", quant), dim=-1)
    h = h.masked_fill(pad[..., None], 0.0)
    w = p["dw/w"].permute(2, 1, 0)                        # [d, 1, k]
    h = F.conv1d(quantize(h.transpose(1, 2), quant), quantize(w, quant),
                 p["dw/b"], padding=m["conv_kernel"] // 2, groups=d)
    h = _swish(_batch_norm(h.transpose(1, 2), p, stats, m))
    return _linear(h, p, "pw2", quant)


def _ffn(x, p: dict, quant):
    return _linear(_swish(_linear(x, p, "in", quant)), p, "out", quant)


def _layer(x, p: dict, pos, mask, pad, uv, stats, m: dict, quant):
    eps = LN_EPS

    def sub(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}

    ff1, att, conv, ff2 = sub("ff1/"), sub("att/"), sub("conv/"), sub("ff2/")
    x = x + 0.5 * _ffn(_layer_norm(x, ff1, "ln", eps), ff1, quant)
    x = x + _attention(_layer_norm(x, att, "ln", eps), att, pos, mask, uv,
                       m, quant)
    x = x + _conv_module(_layer_norm(x, conv, "ln", eps), conv, pad, stats,
                         m, quant)
    x = x + 0.5 * _ffn(_layer_norm(x, ff2, "ln", eps), ff2, quant)
    return _layer_norm(x, sub("out/"), "ln", eps)


def encoder(params: dict, feats: torch.Tensor, flens: torch.Tensor,
            model: dict, quant: str | None = None, train: bool = True,
            remat: bool = False):
    """[B, T, F] features -> (logits [B, T', C] f32, lengths [B]).
    ``train`` normalises by the batch's statistics; ``remat`` recomputes
    each layer in the backward pass."""
    if model.get("frontend") != "conformer":
        raise ValueError("the conformer family computes the Conformer "
                         "model only (model.frontend \"conformer\")")
    m = model
    x = feats[:, None]                                   # [B, 1, T, F]
    for i in range(_stages(m)):
        w = params[f"subsampling/{i}/w"].permute(3, 2, 0, 1)
        x = torch.relu(F.conv2d(quantize(x, quant), quantize(w, quant),
                                params[f"subsampling/{i}/b"], stride=2,
                                padding=1))
    B, C, T, Fp = x.shape
    x = _linear(x.permute(0, 2, 3, 1).reshape(B, T, Fp * C), params,
                "subsampling/out", quant)
    d = m["d_model"]
    if m["xscaling"]:
        x = x * math.sqrt(d)
    pos = positional_embeddings(T, d, x.device)
    lens = subsampled_lengths(flens, m)
    pad = torch.arange(T, device=x.device)[None, :] >= lens[:, None]
    mask = (pad[:, None, :] | pad[:, :, None])[:, None]   # [B, 1, T, T]
    for i in range(m["n_layers"]):
        pre = f"layers/{i}/"
        p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        uv = ((p["att/pos_u"], p["att/pos_v"]) if m["untie_biases"]
              else (params["pos_u"], params["pos_v"]))
        stats = None
        if not train:
            stats = (p.get("conv/bn/mean", torch.zeros(d, device=x.device)),
                     p.get("conv/bn/var", torch.ones(d, device=x.device)))
        args = (p, pos, mask, pad, uv, stats, m, quant)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, *args, use_reentrant=False)
        else:
            x = _layer(x, *args)
    logits = _linear(x, params, "head", quant)
    return logits, lens


def forward_loss(params, batch: dict, cfg: dict, quant=None, remat=False):
    feats, flens = features(batch["samples"], batch["sample_lengths"],
                            cfg["features"])
    logits, lens = encoder(params, feats, flens, cfg["model"], quant,
                           train=True, remat=remat)
    nll = ctc_nll(logits, lens, batch["labels"], batch["label_lengths"])
    return ctc_mean_loss(nll)


# ---------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adamw)
# ---------------------------------------------------------------------------

@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: dict, tcfg: dict) -> dict:
    """One clipped AdamW update in place (decoupled weight decay on every
    leaf, as optax's ``adamw`` with no mask); returns the clipped
    gradients."""
    gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())
                       ).float()
    if tcfg["grad_clip_norm"] > 0 and gnorm >= tcfg["grad_clip_norm"]:
        grads = {k: g / gnorm * tcfg["grad_clip_norm"]
                 for k, g in grads.items()}
    if tcfg["lr_schedule"] != "constant":
        raise ValueError("the reference optimizer runs at a constant rate")
    b1, b2, eps, lr, wd = (tcfg["adam_b1"], tcfg["adam_b2"],
                           tcfg["adam_eps"], tcfg["learning_rate"],
                           tcfg["weight_decay"])
    state["count"] += 1
    k = np.float32(state["count"])
    bc1 = float(np.float32(1.0) - np.float32(b1) ** k)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** k)
    for key, p in params.items():
        g = grads[key]
        mu = state["mu"][key].mul_(b1).add_((1.0 - b1) * g)
        nu = state["nu"][key].mul_(b2).add_((1.0 - b2) * g * g)
        p.sub_(lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p))
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
    remat = next(iter(params0.values())).is_cuda
    losses, grads1 = [], None
    with exact_f32():
        for batch in batches:
            if rows is not None:
                batch = {k: v[rows] for k, v in batch.items()}
            loss = forward_loss(params, batch, cfg, quant, remat)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            clipped = adamw_step(params, grads, state, cfg["train"])
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
    (logits [B, T', C] f32, lengths [B]), by the running statistics."""
    with exact_f32():
        feats, flens = features(samples, lengths, cfg["features"])
        return encoder(params, feats, flens, cfg["model"], quant,
                       train=False)


@torch.no_grad()
def log_probs(params: dict, batch: dict, cfg: dict, quant=None):
    """Decode side: (log-posteriors [B, T', C] f32, lengths [B])."""
    out, lens = logits(params, batch["samples"], batch["sample_lengths"],
                       cfg, quant)
    return torch.log_softmax(out.float(), -1), lens


# ---------------------------------------------------------------------------
# Work: encoder frames, the step's algorithmic FLOPs, the attention core's
# ---------------------------------------------------------------------------

def encoder_frames(n_samples: int, cfg: dict) -> int:
    """Encoder output frames of an utterance of ``n_samples`` samples."""
    t = num_frames(n_samples, cfg["features"])
    for _ in range(_stages(cfg["model"])):
        t = (t - 1) // 2 + 1
    return t


def step_flops(cfg: dict, batch: int, seconds: float) -> float:
    """Algorithmic matmul and conv FLOPs of one train step of ``batch``
    rows of ``seconds`` (forward x 3): the subsampling convs and linear,
    and per layer the feed-forward halves, the q / k / v / output and
    position projections (2T'-1 positions), the attention's scores
    against keys and against positions and its weighted sum (T'^2 of
    each, the pairs the model defines, not the [T', 2T'-1] product a
    relative shift crops), the pointwise and depthwise convs, and the
    head. Norms, activations and the softmax are not counted."""
    m, fcfg = cfg["model"], cfg["features"]
    n = int(round(seconds * fcfg["sample_rate"]))
    t, f, cin = num_frames(n, fcfg), _feat_dim(cfg), 1
    d, C = m["d_model"], m["subsampling_channels"]
    fwd = 0.0
    for _ in range(_stages(m)):
        t, f = (t - 1) // 2 + 1, (f - 1) // 2 + 1
        fwd += 2.0 * t * f * C * 9 * cin
        cin = C
    T = t
    fwd += 2.0 * T * f * C * d
    ff = m["ff_expansion"] * d
    layer = (2 * 2 * 2.0 * T * d * ff            # two FFNs of two linears
             + 4 * 2.0 * T * d * d               # q, k, v, o
             + 2.0 * (2 * T - 1) * d * d         # the positions' projection
             + 3 * 2.0 * T * T * d               # scores x 2, weighted sum
             + 2.0 * T * d * 2 * d               # pointwise in
             + 2.0 * T * d * m["conv_kernel"]    # depthwise
             + 2.0 * T * d * d)                  # pointwise out
    fwd += m["n_layers"] * layer + 2.0 * T * d * m["num_classes"]
    return 3.0 * fwd * batch


def attention_work(cfg: dict, frames) -> dict:
    """The attention core's work in one train step of a batch whose rows
    have ``frames`` encoder frames (unpadded), forward and backward, over
    every layer and head: ``{"flops", "bytes"}``.

    FLOPs: per row and layer the three T'^2 x d products of the forward
    (scores against keys, against positions, the weighted sum) and twice
    that in the backward (each product's two input gradients): 18 T'^2 d.
    Bytes, the least any kernel moves: the forward reads (q + u) / s,
    (q + v) / s, k and v of each row and the projected positions once
    for the batch (2T'-1 rows at the longest T'; the rows share them),
    and writes the output; the backward reads the same and the output's
    gradient and writes the gradient of each input; two bytes (bf16) an
    element. The softmax statistics and the scores are not counted: a
    kernel may keep them on chip."""
    m = cfg["model"]
    d, L = m["d_model"], m["n_layers"]
    frames = [int(t) for t in frames]
    if not frames:
        return {"flops": 0.0, "bytes": 0.0}
    rows = float(sum(frames))
    positions = 2.0 * max(frames) - 1
    flops = 18.0 * d * sum(float(t) * t for t in frames)
    fwd = 4 * rows + positions + rows                 # inputs, output
    bwd = (5 * rows + positions) + (4 * rows + positions)
    return {"flops": L * flops, "bytes": L * 2.0 * d * (fwd + bwd)}
