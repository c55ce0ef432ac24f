"""Sequence (time-axis) parallelism: one process over a list of devices.

Counterpart of ``ctc_asr_tpu/parallel/seqpar.py``. The reference shards
the time axis of the frontend and the encoder over a 'seq' mesh axis of
local devices inside ``shard_map``, in one process (it refuses more
than one, ``ctc_asr_tpu/train.py:305-315``). The port keeps that shape:
one process drives ``n`` time chunks, chunk ``i`` on ``devices[i]``
(``sp_devices``: ``cuda:0 .. cuda:n-1``, or ``n`` shards on the CPU; a
library caller may name one card twice). The reference's collectives
become plain tensor operations:

- each ``ppermute`` (the STFT halo, the conv halos, the wavefront's
  carries) is a differentiable ``.to(next_device)`` copy;
- each ``psum`` (the normalization moments) is a sum gathered on
  ``devices[0]``;
- the ``all_gather`` of the logits is a ``torch.cat`` on ``devices[0]``,
  where the CTC loss and the decoders run.

One parameter set lives on ``devices[0]``; every chunk reads it through a
``.to`` copy, and autograd sums the chunks' gradients into it. So the
reference's ``loss / n`` and its ``psum`` of the per-device gradients
(``seqpar.py:443-450``, ``:481-491``) are artefacts of its SPMD form and
have no counterpart here.

- Frontend: chunk ``i`` is extended by the first ``win - hop`` samples
  of chunk ``i + 1`` (zeros after the last), so K1 (``cfg.use_pallas``)
  or the plain frontend gives exactly ``chunk / hop`` frames a chunk,
  which tile the global frame axis; the ``utterance`` and ``global``
  normalizations take global masked moments.
- SpecAugment draws its spans once, from the train state's generator in
  the unsharded step's order, and each chunk applies its slice of the
  global mask (``features.axis_masks(pos_start=...)``).
- Conv frontend: each layer takes ``lo = (kt - st) // 2`` rows from the
  left neighbour and the rest from the right (zeros at the edges: SAME
  padding), convolves VALID in time and SAME in frequency (a plain
  ``F.conv2d``: the reference computes this conv outside Pallas too) and
  zeroes the rows past the unsharded array's length.
- Recurrences: a wavefront. Stage ``s`` scans chunk ``s`` from the carry
  of chunk ``s - 1``; the backward direction starts from the last chunk.
  The reference scans every chunk at every stage and keeps one (SPMD);
  here each chunk is scanned once, at its stage, with the same result.
  The chunk scan computes ``x @ wx + b`` and the gates in f32, as the
  reference's does (``seqpar.py:173``): a bf16 run differs from the
  unsharded bf16 encoder by bf16 rounding, and matches it at
  ``compute_dtype=float32`` with ``use_pallas_rnn=false``. The scans run
  the plain cells (``models.rnn.cell_step``), as the reference's do; K1
  and the CTC kernels run as configured.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..config import Config, FeatureConfig
from ..features import (_load_stats, axis_masks, decode_wire,
                        frame_lengths_from_sample_lengths, plain_features)
from ..models.encoder import _layer, output_lengths
from ..models.layers import (clipped_relu, dense_apply,
                             deterministic_convs, dropout, dropout_mask)
from ..models.rnn import cell_step, init_carry
from ..ops.ctc_cuda import ctc_loss
from ..ops.dispatch import resolve_device
from ..optim import Adam


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sp_devices(n: int, device) -> list[torch.device]:
    """The ``n`` devices of ``mesh.seq_axis = n``: ``cuda:0 .. cuda:n-1``
    for a CUDA ``device`` (raises when fewer cards exist, as
    ``ctc_asr_tpu/train.py:327-331`` does), ``n`` shards of the CPU for
    the CPU (the counterpart of the reference's virtual CPU devices)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"mesh.seq_axis={n} needs that many local "
                             f"devices, have {have}")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def sp_batch_put(devices: list, arrs):
    """One loader batch for the SP step: the samples split over time into
    ``len(devices)`` chunks, chunk i on ``devices[i]``, the lengths and
    labels on ``devices[0]``. Refuses feature-cache batches and a padded
    width that the devices do not divide (``sp_batch_put``)."""
    samples = torch.as_tensor(arrs[0])
    if samples.dim() == 3:
        raise NotImplementedError(
            "sequence parallelism expects RAW audio on the wire; the "
            "feature-cache batch ([B, T, F] precomputed features) would "
            "be mis-sharded as samples — unset data.feature_cache with "
            "mesh.seq_axis > 1 (SP extracts features per time shard)")
    n = len(devices)
    S = samples.shape[1]
    if S % n != 0:
        raise ValueError(
            f"padded sample width {S} is not divisible by seq_axis={n}; "
            "pick data.num_buckets/seq_axis so bucket widths (hop*8 "
            "multiples) tile over the mesh")
    chunks = [c.to(d) for c, d in zip(samples.split(S // n, dim=1), devices)]
    return (chunks, *(torch.as_tensor(a).to(devices[0]) for a in arrs[1:]))


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------

def _global_mask(lengths: torch.Tensor, i: int, Tc: int, device,
                 time_major: bool = False) -> torch.Tensor:
    """Bool mask of chunk i's rows inside each row's [0, len): [B, Tc]
    (or [Tc, B])."""
    g = i * Tc + torch.arange(Tc, device=device)
    lens = lengths.to(device)
    return g[:, None] < lens[None, :] if time_major else \
        g[None, :] < lens[:, None]


def sp_features(chunks: list, sample_lengths: torch.Tensor,
                cfg: FeatureConfig):
    """Sample chunks [B, S/n] (chunk i on its device; float, int16 or
    uint8 wire) and the global [B] lengths -> (feature chunks [B, S/(n
    hop), F] normalized with global statistics, frame lengths [B] on the
    first chunk's device). Rows past a row's frame length are zero."""
    n = len(chunks)
    hop, win = cfg.hop_length, cfg.win_length
    chunks = [decode_wire(c) for c in chunks]
    B, Cs = chunks[0].shape
    if Cs % hop != 0:
        raise ValueError(f"chunk size {Cs} must be a hop multiple ({hop})")
    halo = win - hop
    feats = []
    for i, c in enumerate(chunks):
        if halo > 0:
            right = (chunks[i + 1][:, :halo].to(c.device) if i + 1 < n
                     else c.new_zeros((B, halo)))
            c = torch.cat([c, right], dim=1)
        if cfg.use_pallas:
            from ..ops.stft_cuda import stft_features
            feats.append(stft_features(c.contiguous(), cfg))
        else:
            feats.append(plain_features(c, cfg))
    dev0 = chunks[0].device
    flens = frame_lengths_from_sample_lengths(sample_lengths.to(dev0), cfg)
    Tc = feats[0].shape[1]
    masks = [_global_mask(flens, i, Tc, f.device)[..., None].float()
             for i, f in enumerate(feats)]

    def psum(parts):
        return sum(p.to(dev0) for p in parts)

    mode = cfg.normalization
    if mode == "none":
        return [f * m for f, m in zip(feats, masks)], flens
    if mode == "utterance":
        n_valid = torch.clamp_min(flens.float(), 1.0)[:, None, None]
        mean = psum([torch.sum(f * m, dim=1, keepdim=True)
                     for f, m in zip(feats, masks)]) / n_valid
        var = psum([torch.sum(torch.square(f - mean.to(f.device)) * m,
                              dim=1, keepdim=True)
                    for f, m in zip(feats, masks)]) / n_valid
    elif mode == "global":
        stats = _load_stats(cfg.stats_path) if cfg.stats_path else None
        if stats is not None:
            mean = torch.as_tensor(stats[0], device=dev0).reshape(1, 1, -1)
            var = torch.as_tensor(stats[1], device=dev0).reshape(1, 1, -1)
        else:
            total = psum([torch.sum(m) for m in masks])
            mean = psum([torch.sum(f * m, dim=(0, 1), keepdim=True)
                         for f, m in zip(feats, masks)]) / total
            var = psum([torch.sum(torch.square(f - mean.to(f.device)) * m,
                                  dim=(0, 1), keepdim=True)
                        for f, m in zip(feats, masks)]) / total
    else:
        raise ValueError(f"unknown normalization mode {mode!r}")
    return [(f - mean.to(f.device)) * torch.rsqrt(var.to(f.device) + 1e-8)
            * m for f, m in zip(feats, masks)], flens


def make_sp_feature_fn(cfg: FeatureConfig, devices: list):
    """``(samples [B, S], lengths [B]) -> (feature chunks, frame
    lengths)``: the samples split over ``devices``, then ``sp_features``.
    The chunks hold S/hop frames in all, slightly more than the
    unsharded pipeline's 1 + (S - win)/hop; the extra rows are zero."""
    def fn(samples, sample_lengths):
        chunks, slens = sp_batch_put(devices, (samples, sample_lengths))
        with torch.no_grad():
            return sp_features(chunks, slens, cfg)
    return fn


def _sp_spec_augment(feats: list, flens: torch.Tensor, tcfg,
                     generator: torch.Generator) -> list:
    """SpecAugment over global frame indices: the spans are drawn once
    from ``generator`` (on its device, in ``features.spec_augment``'s
    order: the time masks' uniforms, then the frequency masks'), and
    each chunk applies its slice of the global mask, so the result is
    the unsharded step's with the same generator."""
    B, Tc, F = feats[0].shape
    gdev = generator.device

    def uniforms(k):
        return (torch.rand((B, k), generator=generator, device=gdev),
                torch.rand((B, k), generator=generator, device=gdev))

    if tcfg.sa_time_masks > 0:
        u_w, u_s = uniforms(tcfg.sa_time_masks)
        lens = flens.float().to(gdev)
        out = []
        for i, f in enumerate(feats):
            d = f.device
            tm = axis_masks(u_w.to(d), u_s.to(d), Tc,
                            torch.floor(tcfg.sa_time_ratio * lens).to(d),
                            lens.to(d), pos_start=i * Tc)
            out.append(f * (1.0 - tm.to(f.dtype))[..., None])
        feats = out
    if tcfg.sa_freq_masks > 0:
        full = torch.full((B,), float(F), device=gdev)
        fm = axis_masks(*uniforms(tcfg.sa_freq_masks), F,
                        torch.full((B,), float(tcfg.sa_freq_width),
                                   device=gdev), full)
        feats = [f * (1.0 - fm.to(f.device, f.dtype))[:, None, :]
                 for f in feats]
    return feats


# ---------------------------------------------------------------------------
# Conv frontend with time halos
# ---------------------------------------------------------------------------

def sp_conv_layer(layer: dict, xs: list, strides, kernel,
                  compute_dtype) -> list:
    """One SAME-padded NHWC conv layer over time chunks [B, Tc, F, C]
    (``_sp_conv_layer_local``): chunk j is extended by ``lo = (kt -
    st) // 2`` rows of chunk j - 1 and ``hi = kt - st - lo`` rows of
    chunk j + 1 (zeros past the edges, which is the SAME padding) and
    convolved VALID in time and SAME in frequency, giving Tc/st rows that
    tile the unsharded output. The conv runs in the compute dtype, the
    bias is added in f32 (``layers.conv2d_apply``)."""
    kt, kf = kernel
    st, sf = strides
    n = len(xs)
    B, Tc, Fq, C = xs[0].shape
    if Tc % st != 0:
        raise ValueError(
            f"SP conv: local time chunk {Tc} not divisible by time "
            f"stride {st}; pick bucket widths/seq_axis so chunks tile")
    total = max(kt - st, 0)
    lo, hi = total // 2, total - total // 2
    if max(lo, hi) > Tc:
        raise ValueError(
            f"SP conv: halo ({lo}/{hi} rows, kernel_t={kt}) exceeds the "
            f"local chunk of {Tc} frames — a single-neighbour exchange "
            "cannot cover it; use fewer seq shards or longer buckets")
    f_out = _cdiv(Fq, sf)
    ftot = max((f_out - 1) * sf + kf - Fq, 0)
    out = []
    for j, x in enumerate(xs):
        d = x.device
        pieces = [x]
        if lo > 0:
            pieces.insert(0, xs[j - 1][:, Tc - lo:].to(d) if j > 0
                          else x.new_zeros((B, lo, Fq, C)))
        if hi > 0:
            pieces.append(xs[j + 1][:, :hi].to(d) if j + 1 < n
                          else x.new_zeros((B, hi, Fq, C)))
        ext = torch.cat(pieces, dim=1) if len(pieces) > 1 else x
        xc = tF.pad(ext.permute(0, 3, 1, 2).to(compute_dtype),
                    (ftot // 2, ftot - ftot // 2, 0, 0))
        w = layer["w"].to(d).permute(3, 2, 0, 1).to(compute_dtype)
        y = tF.conv2d(xc, w, stride=(st, sf))
        out.append(y.permute(0, 2, 3, 1).float() + layer["b"].to(d))
    return out


# ---------------------------------------------------------------------------
# Wavefront recurrences
# ---------------------------------------------------------------------------

def _chunk_scan(cell: str, p: dict, x: torch.Tensor, carry: tuple,
                valid: torch.Tensor):
    """Masked scan of one chunk x [Tc, B, F] from an incoming carry
    (``_chunk_scan``): ``x @ wx + b`` and the gates in f32; ``valid``
    [Tc, B] bool marks the global steps inside each row's window.
    Returns (outputs [Tc, B, H], the final carry)."""
    xg = x.float() @ p["wx"] + p["b"]
    wh = p["wh"]
    outs = []
    for t in range(x.shape[0]):
        carry, o = cell_step(cell, xg[t], carry[0] @ wh, carry,
                             valid[t][:, None].float())
        outs.append(o)
    return torch.stack(outs), carry


def _wavefront(cell: str, p: dict, xs: list, valids: list, order) -> list:
    """Scan the chunks once each, in ``order``, each from the final carry
    of the one before (moved to its device); the first from zeros."""
    H = p["wh"].shape[0]
    outs = [None] * len(xs)
    carry = None
    for j in order:
        d = xs[j].device
        pj = {k: v.to(d) for k, v in p.items()}
        carry = (init_carry(cell, (xs[j].shape[1], H), d) if carry is None
                 else tuple(c.to(d) for c in carry))
        outs[j], carry = _chunk_scan(cell, pj, xs[j], carry, valids[j])
    return outs


def _valids(xs: list, lengths: torch.Tensor) -> list:
    Tc = xs[0].shape[0]
    return [_global_mask(lengths, i, Tc, x.device, time_major=True)
            for i, x in enumerate(xs)]


def sp_rnn(xs: list, lengths: torch.Tensor, params: dict,
           cell: str = "lstm") -> list:
    """Unidirectional wavefront layer: chunks [Tc, B, F] -> [Tc, B, H]."""
    return _wavefront(cell, params, xs, _valids(xs, lengths),
                      range(len(xs)))


def sp_birnn(xs: list, lengths: torch.Tensor, params_fwd: dict,
             params_bwd: dict, cell: str = "lstm") -> list:
    """Bidirectional wavefront layer (``_sp_birnn_local``): chunks
    [Tc, B, F] -> [Tc, B, 2H]. The forward direction runs chunks 0 ..
    n-1; the backward direction reverses each chunk and runs them from
    the last, which is the global time reversal."""
    valids = _valids(xs, lengths)
    n = len(xs)
    fwd = _wavefront(cell, params_fwd, xs, valids, range(n))
    bwd = _wavefront(cell, params_bwd, [x.flip(0) for x in xs],
                     [v.flip(0) for v in valids], reversed(range(n)))
    return [torch.cat([f, b.flip(0)], dim=-1) for f, b in zip(fwd, bwd)]


def make_sp_birnn_fn(params: dict, cell: str = "lstm"):
    """``(chunks [Tc, B, F] on their devices, lengths [B]) -> chunks
    [Tc, B, 2H]`` (``make_sp_birnn_fn``): params {'fwd': ..., 'bwd':
    ...} of ``cell`` (lstm | gru | rnn). The output stays chunked, so
    layers chain with no resharding."""
    def fn(xs, lengths):
        return sp_birnn(xs, lengths, params["fwd"], params["bwd"], cell)
    return fn


# ---------------------------------------------------------------------------
# The encoder and the steps
# ---------------------------------------------------------------------------

def _drop(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Dropout with the mask drawn on the generator's device (a chunk may
    lie on another)."""
    if rate <= 0.0:
        return x
    mask = dropout_mask(x.shape, rate, generator, generator.device)
    return dropout(x, rate, mask=mask.to(x.device))


def sp_encoder(params: dict, chunks: list, sample_lengths: torch.Tensor,
               cfg: Config, train: bool = False, generators=None):
    """Sample chunks -> (logits [B, T', C] on the first chunk's device,
    lengths [B]) (``_sp_encoder_local`` and the gather of the steps):
    features -> [SpecAugment] -> dense | conv frontend -> wavefront
    (bi)RNN stack -> head, every activation in time chunks."""
    mcfg, fcfg = cfg.model, cfg.features
    cdt = getattr(torch, mcfg.compute_dtype)
    dev0 = chunks[0].device
    with torch.no_grad():
        feats, flens = sp_features(chunks, sample_lengths, fcfg)
        if train and cfg.train.specaugment:
            feats = _sp_spec_augment(feats, flens, cfg.train,
                                     generators["specaugment"])
    rate = mcfg.dropout if train else 0.0
    gen = generators["dropout"] if train else None

    def on(prefix, d):
        return {k: v.to(d) for k, v in _layer(params, prefix).items()}

    if mcfg.frontend == "dense":
        xs = feats
        for i in range(mcfg.dense_layers):
            xs = [_drop(clipped_relu(dense_apply(
                on(f"frontend/{i}/", x.device), x, cdt), mcfg.relu_clip),
                rate, gen) for x in xs]
        out_lens = flens.to(torch.int32)
    elif mcfg.frontend == "conv":
        # rows past the UNSHARDED array's length would pick up bias and
        # ReLU after a layer, and the next layer's tail windows would read
        # them where the unsharded SAME padding reads zeros: zero them
        S = chunks[0].shape[1] * len(chunks)
        t_valid = 1 + max(S - fcfg.win_length, 0) // fcfg.hop_length
        xs = [f[..., None] for f in feats]
        for i, (kernel, strides) in enumerate(zip(mcfg.conv_kernels,
                                                  mcfg.conv_strides)):
            layer = _layer(params, f"frontend/{i}/")
            xs = sp_conv_layer(layer, xs, strides, kernel, cdt)
            t_valid = _cdiv(t_valid, strides[0])
            Tl = xs[0].shape[1]
            xs = [_drop(clipped_relu(x, mcfg.relu_clip) * (
                j * Tl + torch.arange(Tl, device=x.device) < t_valid
            )[None, :, None, None].float(), rate, gen)
                for j, x in enumerate(xs)]
        xs = [x.reshape(x.shape[0], x.shape[1], -1) for x in xs]
        out_lens = output_lengths(flens, mcfg)
    else:
        raise ValueError(f"unknown frontend {mcfg.frontend!r}")

    Tc = xs[0].shape[1]
    xs = [(x * _global_mask(out_lens, j, Tc, x.device)[..., None].float())
          .transpose(0, 1) for j, x in enumerate(xs)]       # [Tc, B, D]
    for i in range(mcfg.rnn_layers):
        if mcfg.bidirectional:
            ys = sp_birnn(xs, out_lens, _layer(params, f"rnn/{i}/fwd/"),
                          _layer(params, f"rnn/{i}/bwd/"), mcfg.rnn_type)
        else:
            ys = sp_rnn(xs, out_lens, _layer(params, f"rnn/{i}/"),
                        mcfg.rnn_type)
        xs = [_drop(y, rate, gen) for y in ys]
    logits = [dense_apply(on("head/", x.device), x, cdt) for x in xs]
    full = torch.cat([lg.to(dev0) for lg in logits], dim=0)  # [T', B, C]
    return full.transpose(0, 1), out_lens


def make_sp_train_step(cfg: Config, devices: list):
    """The sequence-parallel train step (``make_sp_train_step``):
    ``(state, samples [B, S], lengths, labels, label lengths) ->
    metrics``, the state on ``devices[0]``. The batch is split over
    ``devices`` (``sp_batch_put``, with its refusals), then features ->
    SpecAugment -> encoder in time chunks -> CTC on the gathered logits
    (K6/K7 as ``train.use_pallas_ctc`` says) -> backward -> global norm
    -> clip -> Adam, as ``train.make_step_fn`` (its convs on cuDNN's
    deterministic algorithms); the generators are the state's, as in one
    process."""
    tcfg = cfg.train
    opt = Adam(tcfg)

    def step_fn(state, *batch):
        chunks, sample_lengths, labels, label_lengths = sp_batch_put(
            devices, batch)
        params = state["params"]
        with deterministic_convs():
            logits, logit_lens = sp_encoder(
                params, chunks, sample_lengths, cfg, train=True,
                generators=state["generators"])
            loss = ctc_loss(logits, logit_lens, labels, label_lengths,
                            use_kernel=tcfg.use_pallas_ctc)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        lr = opt.schedule(state["step"])
        gnorm = opt.step(params, grads, state["opt_state"])
        state["step"] += 1
        return {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}

    return step_fn


def make_sp_eval_step(cfg: Config, devices: list):
    """``(params, samples [B, S], lengths) -> (logits [B, T', C],
    lengths)`` on ``devices[0]`` (``make_sp_eval_step``): the batch split
    over ``devices``, the encoder in time chunks, its logits gathered
    for the decoders."""
    def eval_step(params, samples, sample_lengths):
        chunks, slens = sp_batch_put(devices, (samples, sample_lengths))
        with torch.inference_mode():
            return sp_encoder(params, chunks, slens, cfg)

    return eval_step
