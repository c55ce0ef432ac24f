"""DS1/DS2-style acoustic encoders, and the dispatch to the Conformer.

Counterpart of ``ctc_asr_tpu/models/encoder.py``: a dense (DS1) or
conv2d (DS2) frontend with clipped ReLU (the conv form chosen by
``cfg.conv_as_matmul`` / ``cfg.conv_blocked_fwd``, as in the
reference: blocked banded, full banded or the 2-D conv), a (bi)LSTM /
GRU / vanilla-RNN stack (``cfg.rnn_type``) and a dense head to the vocabulary, returning
pre-softmax logits ``[B, T', C]`` and their lengths. Parameters are the flat keypath dict of
``checkpoint.params_from_jax`` (``frontend/0/w``, ``rnn/0/fwd/wx``,
``head/b``, ...) in the reference's layouts. ``train=True`` adds
dropout after each frontend layer and each RNN layer, and ``cfg.remat``
recomputes each RNN layer in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does in the
reference.

A model config whose ``frontend`` is ``"conformer"``
(``config.ConformerModelConfig``) is the Conformer encoder of
``models/conformer.py``: each function here hands it on, and
``state_shapes`` / ``init_state`` give its model state (BatchNorm's
running statistics; nothing for the RNN encoders).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..utils.profiling import span

from . import conformer
from .layers import (clipped_relu, conv2d_apply, conv2d_blocked_apply,
                     conv2d_matmul_apply, dense_apply, dropout, dropout_mask,
                     glorot)
from .rnn import birnn_apply, rnn_apply


# the profiler ranges around the conv frontend's forward and around each
# RNN layer's (its projection, direction copies, recurrence and dropout;
# inside ``checkpoint`` with ``remat``, so the recomputation is one too);
# their backward is found through the autograd nodes they created
FRONTEND_RANGE = "encoder.frontend"
RNN_RANGE = "encoder.rnn"


def _cdiv(a, b):
    return -(-a // b)


def output_lengths(frame_lengths: torch.Tensor, cfg: ModelConfig):
    """Frontend input frame counts -> encoder output lengths: each
    stride-s SAME conv maps L -> ceil(L / s) on the time axis; the dense
    frontend keeps the length."""
    if cfg.frontend == "conformer":
        return conformer.output_lengths(frame_lengths, cfg)
    lens = frame_lengths.long()
    if cfg.frontend == "conv":
        for (st, _sf) in cfg.conv_strides:
            lens = _cdiv(lens, st)
    return lens.to(torch.int32)


def init_shapes(cfg: ModelConfig, feat_dim: int) -> dict[str, tuple]:
    """Keypath -> shape of every parameter, the same tree as the
    reference's ``init_params``."""
    if cfg.frontend == "conformer":
        return conformer.param_shapes(cfg, feat_dim)
    shapes: dict[str, tuple] = {}
    if cfg.frontend == "dense":
        d = feat_dim
        for i in range(cfg.dense_layers):
            shapes[f"frontend/{i}/w"] = (d, cfg.dense_units)
            shapes[f"frontend/{i}/b"] = (cfg.dense_units,)
            d = cfg.dense_units
        rnn_in = d
    elif cfg.frontend == "conv":
        cin, f = 1, feat_dim
        for i, (ch, (kt, kf), (_st, sf)) in enumerate(zip(
                cfg.conv_channels, cfg.conv_kernels, cfg.conv_strides)):
            shapes[f"frontend/{i}/w"] = (kt, kf, cin, ch)
            shapes[f"frontend/{i}/b"] = (ch,)
            cin, f = ch, _cdiv(f, sf)
        rnn_in = f * cin
    else:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")
    if cfg.rnn_type not in ("lstm", "gru", "rnn"):
        raise ValueError(f"unknown rnn_type {cfg.rnn_type!r}")
    G = {"lstm": 4, "gru": 3, "rnn": 1}[cfg.rnn_type] * cfg.rnn_units
    d = rnn_in
    dirs = ("fwd/", "bwd/") if cfg.bidirectional else ("",)
    for i in range(cfg.rnn_layers):
        for p in dirs:
            shapes[f"rnn/{i}/{p}wx"] = (d, G)
            shapes[f"rnn/{i}/{p}wh"] = (cfg.rnn_units, G)
            shapes[f"rnn/{i}/{p}b"] = (G,)
        d = len(dirs) * cfg.rnn_units
    shapes["head/w"] = (d, cfg.num_classes)
    shapes["head/b"] = (cfg.num_classes,)
    return shapes


def init_params(cfg: ModelConfig, feat_dim: int,
                generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Fresh f32 CPU parameters (``encoder.init_params``): Glorot-uniform
    weights, zero biases, LSTM forget-gate bias 1 (gate order i, f, g,
    o). The values come from ``generator``, not JAX's PRNG."""
    if cfg.frontend == "conformer":
        return conformer.init_params(cfg, feat_dim, generator)
    params = {}
    for k, shape in init_shapes(cfg, feat_dim).items():
        if k.endswith("/b"):
            v = torch.zeros(shape, dtype=torch.float32)
            if k.startswith("rnn/") and cfg.rnn_type == "lstm":
                v[cfg.rnn_units:2 * cfg.rnn_units] = 1.0
        else:
            v = glorot(shape, generator)
        params[k] = v
    return params


def state_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """Keypath -> shape of the model state that no optimizer updates."""
    if cfg.frontend == "conformer":
        return conformer.state_shapes(cfg)
    return {}


def init_state(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A fresh model state (f32 CPU tensors)."""
    if cfg.frontend == "conformer":
        return conformer.init_state(cfg)
    return {}


def _layer(params: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _frontend_layer(fn, params: dict, prefix: str, x: torch.Tensor, tp):
    layer = _layer(params, prefix)
    if tp is not None and tp.shards(prefix + "w"):
        return tp.column_parallel(fn, layer, x)
    return fn(layer, x)


def apply_encoder(params: dict, feats: torch.Tensor,
                  frame_lengths: torch.Tensor, cfg: ModelConfig,
                  train: bool = False,
                  generator: torch.Generator | None = None, tp=None,
                  model_state: dict | None = None):
    """feats [B, T, F], frame_lengths [B] -> (logits [B, T', C] f32,
    lens [B] int32). The LSTM and GRU recurrences go through the CUDA
    kernel wrappers when ``cfg.use_pallas_rnn`` (the reference's kernel
    switch); the vanilla cell has no kernel and runs its plain recurrence.
    ``train`` applies dropout at ``cfg.dropout`` with masks drawn from
    ``generator`` (on the features' device).

    ``tp`` (a ``parallel.tp.TensorParallel``) makes it the
    tensor-parallel encoder: ``params`` then hold this rank's columns of
    the leaves ``tp`` shards, and those layers run column-parallel.

    ``model_state`` is the Conformer's (``conformer.apply``); the RNN
    encoders have none."""
    if cfg.frontend == "conformer":
        if tp is not None:
            raise NotImplementedError("the Conformer has no tensor-parallel "
                                      "form")
        return conformer.apply(params, feats, frame_lengths, cfg, train,
                               generator, model_state)
    cdt = getattr(torch, cfg.compute_dtype)
    rate = cfg.dropout if train else 0.0
    if cfg.frontend == "dense":
        x = feats
        for i in range(cfg.dense_layers):
            x = clipped_relu(_frontend_layer(
                lambda p, v: dense_apply(p, v, cdt), params,
                f"frontend/{i}/", x, tp), cfg.relu_clip)
            x = dropout(x, rate, generator)
        out_lens = frame_lengths.to(torch.int32)
    elif cfg.frontend == "conv":
        if cfg.conv_as_matmul:
            conv_fn = (conv2d_blocked_apply if cfg.conv_blocked_fwd
                       else conv2d_matmul_apply)
        else:
            conv_fn = conv2d_apply
        x = feats[..., None]                         # [B, T, F, 1] NHWC
        with span(FRONTEND_RANGE):
            for i, strides in enumerate(cfg.conv_strides):
                x = clipped_relu(_frontend_layer(
                    lambda p, v: conv_fn(p, v, strides, cdt), params,
                    f"frontend/{i}/", x, tp), cfg.relu_clip)
                x = dropout(x, rate, generator)
        Bc, Tc, Fc, Cc = x.shape
        x = x.reshape(Bc, Tc, Fc * Cc)               # NHWC flatten order
        out_lens = output_lengths(frame_lengths, cfg)
    else:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")

    # zero frontend output past each length (SAME convs smear into pads)
    Tp = x.shape[1]
    vmask = torch.arange(Tp, device=x.device)[None, :] < out_lens[:, None]
    x = x * vmask[..., None].to(x.dtype)

    x = x.transpose(0, 1)                            # [T', B, D]
    width = (2 if cfg.bidirectional else 1) * cfg.rnn_units
    for i in range(cfg.rnn_layers):
        layer = _layer(params, f"rnn/{i}/")
        wx = f"rnn/{i}/fwd/wx" if cfg.bidirectional else f"rnn/{i}/wx"
        rec = {} if tp is None or not tp.shards(wx) else \
            {"recurrence": tp.recurrence}

        def body(layer, inp, mask, rec=rec):
            with span(RNN_RANGE):
                if cfg.bidirectional:
                    y = birnn_apply({"fwd": _layer(layer, "fwd/"),
                                     "bwd": _layer(layer, "bwd/")}, inp,
                                    out_lens, cdt,
                                    use_kernel=cfg.use_pallas_rnn,
                                    rnn_type=cfg.rnn_type, **rec)
                else:
                    y = rnn_apply(layer, inp, out_lens, cfg.rnn_type, cdt,
                                  use_kernel=cfg.use_pallas_rnn, **rec)
                return dropout(y, rate, mask=mask)

        mask = (dropout_mask((x.shape[0], x.shape[1], width), rate,
                             generator, x.device) if rate > 0 else None)
        if cfg.remat and train and torch.is_grad_enabled():
            x = checkpoint(body, layer, x, mask, use_reentrant=False)
        else:
            x = body(layer, x, mask)
    logits = dense_apply(_layer(params, "head/"), x, cdt)   # [T', B, C]
    return logits.transpose(0, 1), out_lens
