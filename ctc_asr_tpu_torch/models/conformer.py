"""The Conformer-CTC encoder: Gulati et al., "Conformer" (arXiv:2005.08100),
as NVIDIA NeMo's ``ConformerEncoder`` computes it with
``self_attention_model: rel_pos`` (``config.ConformerModelConfig``).

- Subsampling ("striding"): log2(factor) Conv2d(3x3, stride 2, pad 1) +
  ReLU over [time, frequency], each mapping L -> (L - 1) // 2 + 1, then
  Linear(channels * F' -> d_model) of each frame's (F', channels)
  values, then x * sqrt(d_model) (``xscaling``) and the sinusoidal
  embeddings of the relative positions T'-1 ... -(T'-1).
- Each block: x += FFN1(LN x) / 2; x += MHSA(LN x); x += Conv(LN x);
  x += FFN2(LN x) / 2; x = LN x. FFN: Linear(d -> ff d) -> Swish ->
  Linear(ff d -> d).
- MHSA, per head of d_k: score(i, j) = [(q_i + u) . k_j + (q_i + v) .
  p_{i-j}] / sqrt(d_k), p = pos @ W_pos (no bias); keys past a row's
  length masked (-10000, as NeMo fills), softmax over j, the weighted sum
  of the values (0 at padded queries, as NeMo's mask gives), W_o. u and v are per layer with ``untie_biases``. The
  relative shift is a strided view of the [T', 2T'-1] product
  (``rel_shift``), not NeMo's pad-and-reshape copy.
- Conv module: pointwise Linear(d -> 2d) -> GLU -> frames past the row's
  length set to 0 -> depthwise conv (kernel k, pad k // 2, bias) ->
  BatchNorm -> Swish -> pointwise Linear(d -> d).
- Head: Linear(d -> classes); the caller takes the log-softmax, blank
  last.

Precision: every matmul and conv takes operands in the compute dtype on
f32 parameters (bf16 on the card: the tensor cores' GEMMs, outputs in
bf16), but the first subsampling conv, which runs in f32; LayerNorm, BatchNorm (its statistics too), the attention's
softmax and the residual stream run in f32. No library attention is
called (``scaled_dot_product_attention`` cannot take the relative term
without a materialised bias): on CUDA tensors at dropout 0 the core is
the hand-written kernel K9 (``ops.attention_cuda``), elsewhere
``rel_queries`` and ``attention_core_plain``.

BatchNorm's running statistics are model state that no optimizer
updates: ``model_state`` (``state_shapes``, ``init_state``) holds them;
a train forward normalises by the batch's statistics (over every frame
of the padded batch, as ``nn.BatchNorm1d`` does in NeMo) and moves the
running ones by ``bn_momentum``; an eval forward normalises by the
running ones, read from ``model_state`` or, where that is None, from
``params`` (a checkpoint's variables, ``checkpoint.load_params``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.attention_cuda import rel_attention
from ..utils.profiling import count, span
from .layers import dense_apply, dropout, glorot

# the profiler ranges of the encoder's layers; the backward of each is
# found through the autograd nodes its forward created
SUBSAMPLING_RANGE = "conformer.subsampling"
FFN_RANGE = "conformer.ffn"                  # each half, its LayerNorm too
ATTENTION_RANGE = "conformer.attention"      # the whole MHSA block
CORE_RANGE = "attention.core"   # scores, shift, mask, softmax, weighted sum
CONV_RANGE = "conformer.conv_module"
# score entries the attention core computed (B x H x T'^2 of each call)
# and those of real frames (H x sum of each row's T'^2)
ENTRIES_COUNTER = "attention.core.entries"
REAL_ENTRIES_COUNTER = "attention.core.real_entries"
# calls of the attention core, and those the fused kernel K9 took
CALLS_COUNTER = "attention.core.calls"
FUSED_COUNTER = "attention.core.fused_calls"

MASK_FILL = -10000.0
LN_EPS = 1e-5                                # LayerNorm's, as NeMo's
_NORMS = ("ff1", "att", "conv", "ff2", "out")


def _stages(cfg) -> int:
    n = int(round(math.log2(cfg.subsampling_factor)))
    if 2 ** n != cfg.subsampling_factor or n < 1:
        raise ValueError(f"subsampling_factor {cfg.subsampling_factor} is "
                         f"not a power of two")
    return n


def output_lengths(frame_lengths: torch.Tensor, cfg) -> torch.Tensor:
    """Feature frames -> encoder frames: each stride-2 conv maps L ->
    (L - 1) // 2 + 1."""
    lens = frame_lengths.long()
    for _ in range(_stages(cfg)):
        lens = torch.div(lens - 1, 2, rounding_mode="floor") + 1
    return lens.to(torch.int32)


def param_shapes(cfg, feat_dim: int) -> dict[str, tuple]:
    """Keypath -> shape of every parameter: dense ``w [in, out]``, convs
    ``w [kh, kw, cin, cout]`` and the depthwise ``w [k, 1, d]``."""
    d, C = cfg.d_model, cfg.subsampling_channels
    shapes: dict[str, tuple] = {}
    cin, f = 1, feat_dim
    for i in range(_stages(cfg)):
        shapes[f"subsampling/{i}/w"] = (3, 3, cin, C)
        shapes[f"subsampling/{i}/b"] = (C,)
        cin, f = C, (f - 1) // 2 + 1
    shapes["subsampling/out/w"] = (f * C, d)
    shapes["subsampling/out/b"] = (d,)
    dk = d // cfg.n_heads
    if not cfg.untie_biases:
        shapes["pos_u"] = shapes["pos_v"] = (cfg.n_heads, dk)
    ff = cfg.ff_expansion * d
    for i in range(cfg.n_layers):
        p = f"layers/{i}/"
        for n in _NORMS:
            shapes[f"{p}{n}/ln/scale"] = shapes[f"{p}{n}/ln/bias"] = (d,)
        for n in ("ff1", "ff2"):
            shapes[f"{p}{n}/in/w"], shapes[f"{p}{n}/in/b"] = (d, ff), (ff,)
            shapes[f"{p}{n}/out/w"], shapes[f"{p}{n}/out/b"] = (ff, d), (d,)
        for n in ("q", "k", "v", "o"):
            shapes[f"{p}att/{n}/w"], shapes[f"{p}att/{n}/b"] = (d, d), (d,)
        shapes[f"{p}att/pos/w"] = (d, d)
        if cfg.untie_biases:
            shapes[f"{p}att/pos_u"] = shapes[f"{p}att/pos_v"] = \
                (cfg.n_heads, dk)
        shapes[f"{p}conv/pw1/w"], shapes[f"{p}conv/pw1/b"] = (d, 2 * d), \
            (2 * d,)
        shapes[f"{p}conv/dw/w"] = (cfg.conv_kernel, 1, d)
        shapes[f"{p}conv/dw/b"] = (d,)
        shapes[f"{p}conv/bn/scale"] = shapes[f"{p}conv/bn/bias"] = (d,)
        shapes[f"{p}conv/pw2/w"], shapes[f"{p}conv/pw2/b"] = (d, d), (d,)
    shapes["head/w"] = (d, cfg.num_classes)
    shapes["head/b"] = (cfg.num_classes,)
    return shapes


def state_shapes(cfg) -> dict[str, tuple]:
    """Keypath -> shape of the model state: each BatchNorm's running mean
    and variance."""
    return {f"layers/{i}/conv/bn/{s}": (cfg.d_model,)
            for i in range(cfg.n_layers) for s in ("mean", "var")}


def init_state(cfg) -> dict[str, torch.Tensor]:
    """Fresh running statistics: mean 0, variance 1."""
    return {k: (torch.ones if k.endswith("/var") else torch.zeros)(
        s, dtype=torch.float32) for k, s in state_shapes(cfg).items()}


def init_value(key: str, shape: tuple) -> torch.Tensor | None:
    """A leaf's fixed starting value: LayerNorm and BatchNorm scales 1,
    their biases, every other bias and u / v 0; None for a weight that
    a Glorot draw fills."""
    if key.endswith("/scale"):
        return torch.ones(shape, dtype=torch.float32)
    if key.endswith(("/b", "/bias", "pos_u", "pos_v")):
        return torch.zeros(shape, dtype=torch.float32)
    return None


def init_params(cfg, feat_dim: int,
                generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Fresh f32 CPU parameters: Glorot-uniform weights from
    ``generator`` (fans from the last two dims, times the receptive
    field), the rest as ``init_value`` gives."""
    out = {}
    for k, shape in param_shapes(cfg, feat_dim).items():
        v = init_value(k, shape)
        out[k] = glorot(shape, generator) if v is None else v
    return out


def _sub(params: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _layers(params: dict, n_layers: int) -> list[dict]:
    """Each block's leaves, ``layers/<i>/`` taken off their keys: one pass
    over the leaves, where a ``_sub`` a block would scan them all again
    on the host at every step."""
    out = [{} for _ in range(n_layers)]
    for k, v in params.items():
        if k.startswith("layers/"):
            i, rest = k[len("layers/"):].split("/", 1)
            out[int(i)][rest] = v
    return out


class _CastLeaves(torch.autograd.Function):
    """f32 leaves to another dtype in one multi-tensor copy, and their
    gradients back to f32 in one: a few launches a step for all of them,
    where a cast a leaf costs two launches a leaf."""

    @staticmethod
    def forward(ctx, dtype, *leaves):
        out = [torch.empty(t.shape, dtype=dtype, device=t.device)
               for t in leaves]
        torch._foreach_copy_(out, list(leaves))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        idx = [i for i, g in enumerate(grads) if g is not None]
        back = [torch.empty(grads[i].shape, dtype=torch.float32,
                            device=grads[i].device) for i in idx]
        torch._foreach_copy_(back, [grads[i].contiguous() for i in idx])
        out = [None] * len(grads)
        for i, g in zip(idx, back):
            out[i] = g
        return (None, *out)


def _is_linear_leaf(key: str) -> bool:
    """A weight or bias of a linear layer (not a conv's, nor the head's,
    which the f32 head product reads as it is)."""
    return key.startswith(("layers/", "subsampling/out/")) and \
        key.endswith(("/w", "/b")) and "/dw/" not in key


def _cast_linears(params: dict, cdt) -> dict:
    """``params`` with every linear layer's leaves in the compute dtype,
    cast together (``_CastLeaves``)."""
    if cdt == torch.float32:
        return params
    keys = [k for k in params if _is_linear_leaf(k)]
    return {**params, **dict(zip(keys, _CastLeaves.apply(
        cdt, *[params[k] for k in keys])))}


def _linear(p: dict, name: str, x: torch.Tensor, cdt) -> torch.Tensor:
    """x @ w + b of ``name/w`` [in, out], ``name/b`` as one GEMM in the
    compute dtype (its output in it too); ``addmm`` on w as it lies gives
    its gradient contiguous, as the multi-tensor cast and Adam take it."""
    w = p[f"{name}/w"].to(cdt)
    y = torch.addmm(p[f"{name}/b"].to(cdt), x.reshape(-1, x.shape[-1])
                    .to(cdt), w)
    return y.view(*x.shape[:-1], w.shape[-1])


def _layer_norm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 of ``name/scale``, ``name/bias``."""
    return F.layer_norm(x.float(), x.shape[-1:], p[f"{name}/scale"],
                        p[f"{name}/bias"], LN_EPS)


def relative_positions(T: int, d: int, device) -> torch.Tensor:
    """[2T - 1, d] f32 sinusoidal embeddings of the positions T-1 down to
    -(T-1): sin at even columns, cos at odd ones."""
    pos = torch.arange(T - 1, -T, -1, device=device,
                       dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float32)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros((2 * T - 1, d), device=device, dtype=torch.float32)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def rel_shift(bd: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T - 1] scores against positions T-1 ... -(T-1) -> the
    [..., T, T] view whose (i, j) is the score against position i - j,
    column (T - 1) - i + j of row i: a strided view of ``bd``
    (contiguous), no copy."""
    *lead, T, P = bd.shape
    if P != 2 * T - 1 or not bd.is_contiguous():
        raise ValueError(f"rel_shift wants contiguous [..., T, 2T-1], got "
                         f"{tuple(bd.shape)}")
    stride = list(bd.stride())
    stride[-2] = P - 1
    return bd.as_strided((*lead, T, T), stride,
                         bd.storage_offset() + T - 1)


def rel_queries(q: torch.Tensor, u: torch.Tensor,
                vb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """qu = (q + u) / sqrt(d_k) and qv = (q + v) / sqrt(d_k) of q [B, H,
    T, d_k] and the biases u, v [H, d_k] (f32): each sum and scale in
    f32, rounded once to q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    return (((qf + u[:, None, :]) * scale).to(q.dtype),
            ((qf + vb[:, None, :]) * scale).to(q.dtype))


def attention_core(q: torch.Tensor, u: torch.Tensor, vb: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
                   key_pad: torch.Tensor, lens: torch.Tensor,
                   rate: float = 0.0, generator=None) -> torch.Tensor:
    """The attention of every head: q, k, v [B, H, T, d_k] and p [H,
    2T-1, d_k] in the compute dtype, the biases u, v [H, d_k] (f32), the
    rows' lengths ``lens`` [B] int32 and ``key_pad`` [B, T] (True at and
    past them) -> [B, H, T, d_k] in the compute dtype, 0 at padded
    queries (NeMo masks their every key and zeroes the weights). CUDA
    tensors at ``rate`` 0 go to the fused kernel K9, which raises for a
    dtype or head width it does not take; CPU tensors and calls with
    dropout to ``rel_queries`` and ``attention_core_plain``."""
    with span(CORE_RANGE):
        count(CALLS_COUNTER, 1)
        if q.is_cuda and rate <= 0.0:
            count(FUSED_COUNTER, 1)
            return rel_attention(q, u, vb, k, v, p, lens)
        return attention_core_plain(*rel_queries(q, u, vb), k, v, p,
                                    key_pad, rate, generator)


def attention_core_plain(qu: torch.Tensor, qv: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
                         key_pad: torch.Tensor, rate: float = 0.0,
                         generator=None) -> torch.Tensor:
    """``attention_core`` in plain PyTorch from qu = (q + u) / sqrt(d_k),
    qv = (q + v) / sqrt(d_k) [B, H, T, d_k] (``rel_queries``): the scores
    sum, mask and softmax in f32; dropout of the probabilities at
    ``rate``."""
    scores = torch.matmul(qu, k.transpose(-2, -1)).float()
    bd = torch.matmul(qv, p.transpose(-2, -1))           # [B, H, T, 2T-1]
    scores = scores.add_(rel_shift(bd))
    scores = scores.masked_fill_(key_pad[:, None, None, :], MASK_FILL)
    probs = dropout(torch.softmax(scores, dim=-1), rate, generator)
    o = torch.matmul(probs.to(v.dtype), v)
    return o.masked_fill(key_pad[:, None, :, None], 0.0)


def _mhsa(p: dict, x: torch.Tensor, pos: torch.Tensor, key_pad, lens, uv,
          cfg, cdt, rate: float, generator) -> torch.Tensor:
    """The self-attention block of a layer's ``att/`` leaves."""
    with span(ATTENTION_RANGE):
        B, T, d = x.shape
        H = cfg.n_heads
        dk = d // H

        def heads(y):                         # [B, T, d] -> [B, H, T, dk]
            return y.view(B, T, H, dk).transpose(1, 2)

        h = _layer_norm(p, "ln", x).to(cdt)
        q, k, v = (heads(_linear(p, n, h, cdt)) for n in ("q", "k", "v"))
        pp = (pos @ p["pos/w"].to(cdt)).view(-1, H, dk) \
            .transpose(0, 1)                            # [H, 2T-1, dk]
        o = attention_core(q, *uv, k, v, pp, key_pad, lens, rate, generator)
        return _linear(p, "o", o.transpose(1, 2).reshape(B, T, d), cdt)


def _ffn(p: dict, x: torch.Tensor, cfg, cdt, rate: float,
         generator) -> torch.Tensor:
    """A feed-forward half of its leaves ``p`` (``ff1/`` or ``ff2/``)."""
    with span(FFN_RANGE):
        h = _layer_norm(p, "ln", x).to(cdt)
        h = dropout(F.silu(_linear(p, "in", h, cdt)), rate, generator)
        return _linear(p, "out", h, cdt)


def _conv_module(p: dict, x: torch.Tensor, pad: torch.Tensor, mean,
                 var, cfg, cdt, train: bool) -> torch.Tensor:
    """The conv module of a layer's ``conv/`` leaves; ``pad`` [B, T] True
    past each row's length; ``mean`` / ``var`` the running statistics
    (moved in training where given, else read)."""
    with span(CONV_RANGE):
        B, T, d = x.shape
        h = _layer_norm(p, "ln", x).to(cdt)
        h = F.glu(_linear(p, "pw1", h, cdt), dim=-1)
        h = h.masked_fill(pad[..., None], 0.0)
        w = p["dw/w"].permute(2, 1, 0).to(cdt)           # [d, 1, k]
        h = F.conv1d(h.transpose(1, 2), w, padding=cfg.conv_kernel // 2,
                     groups=d)
        # the bias added in f32: BatchNorm cancels it, and its gradient is
        # then a sum of f32 terms that cancel, not of bf16-rounded ones
        h = h.float().transpose(1, 2).reshape(B * T, d) + p["dw/b"]
        h = F.batch_norm(h, mean, var, p["bn/scale"], p["bn/bias"],
                         training=train, momentum=cfg.bn_momentum,
                         eps=cfg.bn_eps)
        return _linear(p, "pw2", F.silu(h).view(B, T, d), cdt)


def _subsample(params: dict, feats: torch.Tensor, cfg, cdt) -> torch.Tensor:
    """[B, T, F] features -> [B, T', d] f32 (x-scaled)."""
    with span(SUBSAMPLING_RANGE):
        x = feats[:, None].float()                       # [B, 1, T, F]
        for i in range(_stages(cfg)):
            # the first conv (one input channel, little work) runs in f32
            # and rounds its output after the bias: with bf16 features
            # its bias's gradient moves by percents
            dt = torch.float32 if i == 0 else cdt
            w = params[f"subsampling/{i}/w"].permute(3, 2, 0, 1).to(dt)
            y = F.conv2d(x.to(dt).contiguous(memory_format=torch.channels_last),
                         w.contiguous(memory_format=torch.channels_last),
                         params[f"subsampling/{i}/b"].to(dt), stride=2,
                         padding=1)
            x = torch.relu_(y.to(cdt))
        B, C, Tp, Fp = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, Tp, Fp * C)   # (F', C) a frame
        x = _linear(params, "subsampling/out", x, cdt).float()
        return x * math.sqrt(cfg.d_model) if cfg.xscaling else x


def apply(params: dict, feats: torch.Tensor, frame_lengths: torch.Tensor,
          cfg, train: bool = False, generator: torch.Generator | None = None,
          model_state: dict | None = None):
    """feats [B, T, F], frame_lengths [B] -> (logits [B, T', C] f32, lens
    [B] int32). ``train`` normalises the conv modules by the batch's
    statistics, moves ``model_state``'s running statistics in place
    (where given) and applies dropout at ``cfg.dropout`` from
    ``generator``; otherwise the running statistics normalise
    (``model_state``'s, or where it is None those in ``params``)."""
    cdt = getattr(torch, cfg.compute_dtype)
    rate = cfg.dropout if train else 0.0
    stats = params if model_state is None else model_state
    if train and model_state is None:
        stats = {}                      # batch statistics, nothing kept
    params = _cast_linears(params, cdt)
    x = dropout(_subsample(params, feats, cfg, cdt), rate, generator)
    lens = output_lengths(frame_lengths, cfg)
    B, T, d = x.shape
    key_pad = torch.arange(T, device=x.device)[None, :] >= lens[:, None]
    with torch.no_grad():
        count(ENTRIES_COUNTER, cfg.n_layers * B * cfg.n_heads * T * T)
        count(REAL_ENTRIES_COUNTER,
              cfg.n_layers * cfg.n_heads * (lens.long() ** 2).sum())
    pos = relative_positions(T, d, x.device).to(cdt)

    def block(p, x, i):
        uv = ((p["att/pos_u"], p["att/pos_v"]) if cfg.untie_biases
              else (params["pos_u"], params["pos_v"]))
        mean = stats.get(f"layers/{i}/conv/bn/mean")
        var = stats.get(f"layers/{i}/conv/bn/var")
        if not train and (mean is None or var is None):
            raise KeyError(f"no running statistics of layer {i}'s "
                           f"BatchNorm to evaluate with")
        # the residual stream stays f32: each add promotes its branch
        x = torch.add(x, dropout(_ffn(_sub(p, "ff1/"), x, cfg, cdt, rate,
                                      generator), rate, generator), alpha=0.5)
        x = torch.add(x, dropout(_mhsa(_sub(p, "att/"), x, pos, key_pad,
                                       lens, uv, cfg, cdt, rate, generator),
                                 rate, generator))
        x = torch.add(x, dropout(_conv_module(_sub(p, "conv/"), x, key_pad,
                                              mean, var, cfg, cdt, train),
                                 rate, generator))
        x = torch.add(x, dropout(_ffn(_sub(p, "ff2/"), x, cfg, cdt, rate,
                                      generator), rate, generator), alpha=0.5)
        return _layer_norm(p, "out/ln", x)

    for i, p in enumerate(_layers(params, cfg.n_layers)):
        x = block(p, x, i)
    logits = dense_apply(_sub(params, "head/"), x, cdt)
    return logits, lens
