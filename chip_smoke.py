#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ctc_asr_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):

1. Device: name, compute capability, ``nvidia-smi`` name and power
   limit, torch / CUDA / nvcc versions. Needs CUDA with capability 9.0.
2. Build: compiles the CUDA kernels from ``ctc_asr_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together).
3. Kernels versus their plain PyTorch versions, at the main paths'
   shapes: max error against a stated tolerance, and the median of
   CUDA-event times over repeated runs after warm-up. K1 (STFT, an FFT
   a frame) at the train step's B=128 x 8 s, the decode slice's B=16 and
   B=1 x 3.52 s, MFCC, n_fft 256 (the window folded) and 1024, and a
   low-energy input with an all-zero tail, each also timed on the device
   alone by ``torch.profiler``, beside its bound, the old DFT-as-matmul
   bound and ``torch.stft`` (the DFT power alone, a partial yardstick),
   and both the kernel and the plain version held against an f64
   evaluation of the same function; K1's direct-DFT route (an n_fft
   that is not a power of two) at n_fft=400, B=128 x 8 s and n_fft=320,
   held and timed the same way; n_fft=4096 and a direct-DFT block above
   the shared memory must be refused before any launch. K2 (LSTM
   forward) at the serving shapes; K6/K7 (CTC α, β +
   gradient) at the train geometry B=128, T'=399, U=96 with ragged
   lengths, one empty and one infeasible row, and at T = 1 to 12 (which
   spans both kernels' prefetch rings) and at ``cli train``'s B=16,
   T'=175, K6's α equal to the plain version's bit for bit, each CTC
   kernel also timed on the device alone by ``torch.profiler``; K2 with
   residuals and K3 (LSTM BPTT)
   at nd=2, B=128, T=399, H=512 and H=800, at the serving and cli-train
   batch B=16, T=200, H=512 (another tiling of both kernels) and at T=1;
   K2 also at the ds3 width H=800, and K1 and K2 at the decode slice's
   own shapes (B=16 and B=1, 3.52 s, T=175). Each recurrence kernel is
   one cooperative launch a layer on the plan ``plan_recurrence`` gives
   (printed, with µs a step and the step barrier's own cost; two runs
   must give equal bits); K8's top-K selection alone on crafted keys
   (ties, NEG, positive scores, -0 / +0, K = 1 to 512) against a stable
   sort, and its own time; K8 (prefix beam search) on seeded logits at
   B=128, T=400, C=29, K=64 in four modes (acoustic, order-4 char-LM
   fusion, an order-5 table, N-best), at B=1 and at the decode path's
   own shapes (B=16 x 175 frames with the N-best emitted, B=1 x 100),
   with µs a step. Beside each kernel's
   time: its bound on this card (the bytes the function must move,
   once, over the memory rate, or the operations it needs over the peak
   rate, whichever is larger) and, where one PyTorch call computes the
   same function, that call's time (``ctc_loss``, cuDNN ``nn.LSTM`` /
   ``nn.GRU``), which the port itself never calls. Then the frontend
   convs (no TPU kernel: the reference computes them with XLA), conv 1
   -> clipped ReLU -> conv 2 of ``conv_bilstm3`` at B=128 x 8 s (forward,
   and forward + backward) and at the serving batch B=16 x 350 frames
   (forward), in the three forms the encoder selects by
   ``model.conv_as_matmul`` / ``model.conv_blocked_fwd`` (blocked band,
   full band, the 2-D cuDNN conv) and three other ways of computing the
   banded time conv, each against the f32 2-D conv with its FLOP bound.
   Then K9 (the Conformer's fused relative-position attention, forward
   and backward; no TPU kernel) at the Conformer cell's B=64, 8 heads of
   64, T' 216 and 422 with each bucket's ragged lengths: output and
   gradients against the plain core in f32, two backward calls bit-equal,
   its times beside its bound, the plain core and
   ``scaled_dot_product_attention`` on a materialised bias, and the peak
   memory of one layer's forward + backward.
4. Serving slice: a seeded random checkpoint at full ``conv_bilstm3``
   width in the reference's keypath format, a synthetic corpus, then
   the port's ``cli evaluate`` and ``cli transcribe`` on ``cuda``. The
   kernels' launch counters must rise during that run, and the
   encoder's count of layers sent to their plain recurrence for want of
   a kernel plan must stay at 0 (here and in every later slice). Every
   eval batch
   then goes through the kernel path and the plain path: finite logits
   of the expected shape and lengths, and a per-frame argmax that
   agrees on at least 99.5% of the valid frames.
5. Train slice: a random full-width ``conv_bilstm3`` train state
   written as a checkpoint, then ``cli train --device=cuda`` on the
   synthetic corpus at B=16, to a checkpoint halfway and resumed from
   it to the end. The loss and the gradient norm stay finite, the loss
   falls, and the launch counters of K1, K2, K3, K6 and K7 all rise.
   ``cli evaluate`` runs on the trained checkpoint. Then one step at
   B=128 x 8 s from one state through the kernel path and the plain
   path (f32 compute): relative loss and gradient-norm errors and the
   smallest per-leaf cosine of the gradients against stated limits, the
   step's time on the kernel path and the plain path, and where the
   kernel path's step goes: CUDA events between its phases and a
   ``torch.profiler`` split of its device time by kernel group (the
   frontend's group by the encoder's profiler range and the autograd
   nodes it created, whichever conv form runs); the same step with
   ``--model.conv_as_matmul=false`` in turns with the default
   (default, 2-D, 2-D, default) and profiled alike.
6. Decode slice: a seeded random checkpoint at full ``lm_fusion_960h``
   width (5 x BiLSTM-800), a char LM (order 4) and a word LM (order 2)
   trained by ``cli train-lm`` from the synthetic corpus, then ``cli
   evaluate --preset lm_fusion_960h`` with fusion, the same with word-LM
   rescoring, ``--preset deepspeech_beam``, ``cli transcribe`` for
   greedy, beam and beam + fusion, and ``cli evaluate
   --decode.method=beam`` on the trained ``conv_bilstm3`` checkpoint.
   The launch counters of K1, K2 and K8 must rise; every eval batch
   then goes through the kernel path and the plain path of the ds3
   model, held as in phase 4, and its logits through K8 and the plain
   beam search, which must agree.
   Prints the steady-state RTF per mode and the B=1 latencies.
7. GRU family: K4 (GRU forward, inference and residual mode) and K5
   (GRU BPTT), each one cooperative launch a layer, against their plain
   versions at nd=2 and every shape a main path gives them: B=128,
   T=399, H=512 (the train step), B=16, T=200, H=512 (cli train and
   serving: 16 units a block), B=16, T=175, H=800 (the ds3 width) and
   B=128, H=400 (16 x an odd number: 32 units a block, K5's halves of
   K rounded up to whole atoms), with rows of length T, 1 and 0; the
   plans, µs a step, the barrier's own cost, two runs bit-equal at
   B=128, beside their bounds and cuDNN ``nn.GRU``. Then
   the GRU slice at full width: ``cli train --preset conv_bilstm3
   --model.rnn_type=gru`` (20 steps to a checkpoint, resumed to 40: K1,
   K4, K5, K6, K7 launch, K2 and K3 do not), ``cli evaluate`` and ``cli
   transcribe`` on its checkpoint, the kernel path against the plain
   path on every eval batch, and the B=128 x 8 s step held and timed as
   in phase 5. A short ``cli train --model.rnn_type=rnn`` runs the
   vanilla cell's plain recurrence on the card (it has no kernel in
   either package).
8. Data tools on the GRU model: ``cli compute-stats``, ``cli
   prepare-features`` (f16 and int8), ``cli train`` and ``cli evaluate``
   with ``--data.feature_cache`` (K1 must not launch, K4 must; WER from
   the f16 cache against WER from wavs), and ``--train.profile_dir``
   (the trace must name the GRU kernel).
9. Data parallelism across processes (``ctc_asr_tpu_torch.parallel``),
   in two forms the one card allows (NCCL puts no two ranks on one
   GPU). (a) NCCL at world size 1, the group formed here: the B=128 x
   8 s LSTM step through the DP step must equal the single-process step
   bit for bit (loss, gradient norm, every parameter after the update),
   and the all-reduce of the ~17 M-value gradient buffer is timed.
   (b) Two processes sharing the card in a gloo group: the script
   starts itself twice as a worker (``--dp-worker``), both building the
   kernels cold into one directory together; full-width
   ``conv_bilstm3`` at B=16 a rank, dropout 0, ``cli train`` to step
   20 and resumed to 40, then ``cli evaluate`` greedy and beam. K1, K2,
   K3, K6 and K7 (and K8 in the beam evaluation) must launch on each
   rank, the ranks' parameters must be bit-equal, step 1 must agree
   with one process at B=32 on the same global batch (loss 1e-3,
   gradient norm 2e-2), the loss must fall and each evaluation must
   count the whole corpus. Prints the card's compute mode and the step
   time of each form beside the one-process step.
10. Tensor parallelism (``--mesh.model_axis=2 --mesh.shard_model=true``)
   in two processes sharing the card in a gloo group (``--tp-worker``):
   full-width ``conv_bilstm3`` at B=16, dropout 0, ``cli train`` to step
   10 and resumed to 20; step 1 against one process on the same batch
   (loss 1e-3, gradient norm 2e-2), the replicated leaves bit-equal
   across the ranks, the loss falling, K1, K6 and K7 launching on each
   rank and K2 to K5 not (the reference's TP kernel policy); ``cli
   evaluate`` in one process on the TP checkpoint; the step time of two
   ranks and of one process, and of a step's gate gather. The same two
   ranks then decode B=16 x 175 frames with the order-4 char LM's table
   row-sharded over them at ``lm_fusion_960h``'s beam of 64: the ids must
   equal the replicated-table plain decoder's; ms a batch.
11. Sequence parallelism in one process over ``["cuda:0", "cuda:0"]``:
   full-width ``conv_bilstm3`` at f32 with the plain recurrence, B=16 x
   56320 samples: K1 on one extended chunk ([16, 28400] samples) against
   its plain version; the SP step against the unsharded step (loss 1e-3,
   gradient norm 2e-2, every leaf's cosine >= 0.999); the SP eval step's
   argmax agreement >= 99.5%; K1, K6 and K7 launching in three SP train
   steps, K2 to K5 not; both steps' times.
12. The accuracy ladder's runner (``ctc_asr_tpu_torch.scripts.
   run_ladder_hard``) in process at full width and tiny scale: 64 / 16 /
   32 utterances of the hard corpus, B=16, 2% of the step budgets,
   ``--rungs pr1`` and then ``--rungs ds2,ds3 --specaug-ab``, each
   counted from 0. K1 (MFCC in the first run, mel in the second), K2,
   K3, K6 and K7 must launch in both, K8 in the second, K4 and K5 in
   neither; the records and sidecars must carry the reference's record
   keys and sidecar names (``docs/results/ladder_hard_r4``). Phases 3
   and 5 also hold K2 and K3 at the ladder's B=32 shapes (nd=1, H=256,
   T=734; nd=2, H=800, T=367), K1 at its B=32 x 7.36 s batches (pr1's
   MFCC, 26 of 80 mels, and the conv rungs' log-mel) and K6 / K7 at
   pr1's B=32, T'=734, U=72 (S=145).
13. The OOV rung and settler (``scripts.run_oov``) at full width on a
   tiny r4big (``run_ladder_hard --rungs ds2sa,ds3sa`` as in phase 12,
   each arm's last checkpoint named ``step_00008000.npz``), on 32 / 16 /
   32 utterances: K1, K2 and K8 must launch in ``run_oov``, K3 to K7
   not; its 19 records and 11 sidecars must carry the reference's keys,
   labels and names (``docs/results/oov_r5``).
14. The five round-1 synth runners (``scripts.run_synth_e2e``, ``_ds2``,
   ``_lm``, ``_ds3``, ``_holdout``) at full width on their default
   corpora, 20-40 steps each, counted together: K1, K2, K3, K6, K7 and
   K8 must launch, K4 and K5 not; each returns the reference's JSON
   keys, and in e2e the plain beam search and K8 give the same WER.
   Phase 3 also holds each kernel at these runners' own batches against
   its plain version: K1 at e2e's MFCC (26 of 40 mels, B=8 x
   1.71 s) and ds3's log-mel (B=8 x 2.79 s); K2 and K3 at nd=1, B=8,
   T=171, H=256 (e2e), nd=2, B=16, T=135, H=256 (ds2) and nd=2, B=8,
   T=140, H=800 (ds3); K8 at beam 16 (e2e B=8 x 171, ds2 B=16 x 135,
   holdout B=16 x 189, acoustic; synth_lm's order-3 fusion with the beam
   emitted for its N-best) and at beam 64 (ds3, B=8 x 140).
15. Reproducibility (``phase_repro``, after phase 8): a run on the card
   gives the same bits from the same seed. ``cli train`` of
   ``conv_bilstm3`` at full width, B=16, two length buckets, dropout and
   SpecAugment on, 20 steps, twice: once with ``--train.precompile=true``
   (one warm step a bucket shape before step 0) and once with ``false``;
   every logged loss, gradient norm and rate and every array of the
   final checkpoint (parameters, Adam moments, generators) must be
   bit-equal. The same pair with ``--model.rnn_type=gru``. Two runs of
   three B=128 x 8 s steps from the seed's state, bit-equal, for each
   cell, with the steps' times; one B=128 x 8 s LSTM step under strict
   ``torch.use_deterministic_algorithms(True)`` in a child process
   (``--strict-worker``, ``CUBLAS_WORKSPACE_CONFIG=:4096:8``) must raise
   nothing.
16. Prints a ``{"kernels": [...]}`` line (each kernel's launches on every
   path, ``ladder_launches``, ``oov_launches``, ``synth_launches`` and
   ``repro_launches`` among them), the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

STFT_TOL = 2e-3    # f32 log-mel / MFCC, max abs
# bf16 h output: one bf16 ulp at |h| in [0.5, 1) is 2**-8 = 3.9e-3, and
# an f32 sum-order difference of 1e-7 that straddles a rounding boundary
# shows as that ulp; allow two.
LSTM_TOL = 8e-3
ARGMAX_AGREEMENT = 0.995
# The GRU model on random weights: its logits have std ~0.05 like the
# LSTM's, and measured agreement is 0.9954, at the limit above, where the
# cuDNN convs' choice of algorithm could tip it. The limit above holds
# for the checkpoint the GRU slice trains; the random weights get this
# floor, and their agreement is printed.
ARGMAX_AGREEMENT_RANDOM_GRU = 0.99
# CTC (f32 log space): α equal bits, the NLL relative, the gradient
# -exp(α+β-logP) in [-1, 0] absolute. Kernel and plain version do the
# same operations per state in the same order; the NLL's and gradient's
# limits allow for expf/logf's last bits and sum order, as α+β-logP is a
# difference of numbers ~500 whose ulp is 3e-5.
CTC_NLL_RTOL = 1e-5
CTC_GRAD_ATOL = 1e-4
# BPTT on the same bf16 residuals: dgates are bf16 (two ulps relative to
# the largest), and a sum-order flip of one bf16 rounding propagates
# along the reverse chain; db is the f32 sum of those dgates, dwh the
# matmul of bf16 h and dgates.
BPTT_RTOL = 2e-2
# One train step at B=128 x 8 s, kernel path against the plain path at
# f32 compute. The kernel path rounds xproj, wh, h, the residuals and
# dgates to bf16; measured on the H100 its per-leaf gradient cosines
# against f32 are >= 0.99998 and its loss within 1e-4. The plain path at
# bf16 compute (the reference's scan arithmetic) is printed beside it:
# it sums each step's dwh in bf16, as the scan's transpose does, and
# its wh cosines against f32 are ~0.989 at T'=399.
STEP_LOSS_RTOL = 1e-3
STEP_GNORM_RTOL = 2e-2
STEP_MIN_COSINE = 0.999
# WER from the f16 feature cache against WER from wavs on one checkpoint:
# the cache rounds the normalized features to f16 (2**-11 relative), which
# moves a logit by ~1e-3; a frame whose top-2 margin is smaller may flip.
CACHE_WER_TOL = 0.02
# Beam search, kernel against plain version on the same logits: ids and
# lengths identical for every row whose two best final scores differ by
# more than BEAM_TIE (a closer pair may swap on the last bit of an
# expf/logf); N-best scores, f32 sums of a few hundred log-probs,
# relative.
BEAM_TIE = 1e-3
BEAM_SCORE_RTOL = 1e-4

# Published peaks of one H100 SXM at its 700 W limit: HBM3 bytes/s, dense
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


def bound(n_bytes: float, n_ops: float, peak_ops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations
    at their type's peak rate, whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = n_ops / peak_ops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch
    from ctc_asr_tpu_torch.ops import build
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"[device] {name} capability={cap} count="
        f"{torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} nvcc: {nvcc}")
    if cap != (9, 0):
        raise RuntimeError(f"need compute capability (9, 0), have {cap}")
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from ctc_asr_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.load()
    info = build.build_info
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info.get('seconds', 0.0):.2f} s, cached="
        f"{info.get('cached')})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")


def _speechlike(B: int, S: int, seed: int):
    import torch
    rng = np.random.default_rng(seed)
    t = np.arange(S) / 16000.0
    f = rng.uniform(150, 3000, (B, 1))
    x = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal((B, S))
    return torch.from_numpy(x.astype(np.float32)).cuda()


def _stft_bounds(cfg, B: int, S: int) -> tuple[dict, float]:
    """K1's bound: the samples read and the features written once (and
    the kernel's constants), or the operations its function needs at the
    f32 peak: an n_fft/2-point complex FFT (5 (N/2) log2(N/2)), the real
    split (~10 a point), the window, the power, the sparse mel product,
    the log and the DCT. Second, in ms, the old DFT-as-matmul bound (both
    bases over the W window samples and the dense mel product), printed
    so the bound's history reads."""
    import math
    from ctc_asr_tpu_torch.features import num_frames
    from ctc_asr_tpu_torch.ops import stft_cuda
    fb, nb = stft_cuda._filterbank(cfg)
    use_dct = cfg.feature_type == "mfcc"
    T, W, N, M, F = (max(1, num_frames(S, cfg)), cfg.win_length, cfg.n_fft,
                     cfg.n_mels, cfg.feature_dim)
    nh, nnz = N // 2, int((fb != 0).sum())
    consts = W + 2 * N + nnz + 2 * M + 1 + (M * F if use_dct else 0)
    frame_ops = (5 * nh * math.log2(nh) + 10 * nh + W + 3 * nb + 2 * nnz + M
                 + (2 * M * F if use_dct else 0))
    nbd = N // 2 + 1
    old = bound(4 * (B * S + B * T * M + 2 * W * nbd + nbd * M),
                B * T * (4 * W * nbd + 3 * nbd + 2 * nbd * M), PEAK_F32)
    return (bound(4 * (B * S + B * T * F + consts), B * T * frame_ops,
                  PEAK_F32), old["bound_ms"])


def _features_f64(x, cfg):
    """The features of ``x`` evaluated in f64: the same f32 window,
    filterbank and DCT values as the kernel and the plain version, an
    exact DFT (its basis built in f64, not rounded to f32) and f64
    arithmetic throughout. An independent witness of which of the two
    f32 evaluations is nearer the function."""
    import torch
    from ctc_asr_tpu_torch import features as feat_mod
    W, N = cfg.win_length, cfg.n_fft
    ang = (2.0 * np.pi / N) * np.outer(np.arange(W), np.arange(N // 2 + 1))

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=x.device)

    frames = feat_mod.frame_signal(x.double(), cfg) \
        * f64(feat_mod.hann_window(W))
    power = (frames @ f64(np.cos(ang))) ** 2 + (frames @ f64(np.sin(ang))) ** 2
    fb = feat_mod.mel_filterbank(N, cfg.n_mels, cfg.sample_rate, cfg.fmin,
                                 cfg.fmax)
    out = torch.log(torch.clamp_min(power @ f64(fb), 1e-6))
    if cfg.feature_type == "mfcc":
        out = out @ f64(feat_mod.dct_matrix(cfg.n_mels, cfg.n_mfcc))
    return out


def _stft_power_ms(x, cfg) -> float:
    """A partial yardstick for K1: ``torch.stft`` (cuFFT; center=False,
    the Hann window zero-padded at its end to n_fft, the same hop) and
    ``.abs() ** 2``, the DFT power alone, without the mel, the log or the
    DCT. Timed here only; the port never calls it."""
    import torch
    from ctc_asr_tpu_torch.features import hann_window
    win = torch.zeros(cfg.n_fft, device=x.device)
    win[:cfg.win_length] = torch.as_tensor(hann_window(cfg.win_length),
                                           device=x.device)
    return cuda_ms(lambda: torch.stft(
        x, cfg.n_fft, cfg.hop_length, window=win, center=False,
        return_complex=True).abs() ** 2, reps=20)


PROFILE_TRIES = 3


def _trace(run, ok, what: str, cpu: bool = True):
    """The ``torch.profiler`` events of ``run()``, traced again (each time
    logged, at most ``PROFILE_TRIES`` traces) while ``ok(events)`` is
    false: now and then a trace on the H100 holds none of a session's
    kernels (one of four ``chip_smoke`` runs, in ``phase_ctc``). The
    results checked elsewhere do not depend on it; only the times do."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=acts) as prof:
            run()
        evs = prof.events()
        if ok(evs):
            return evs
        log(f"[profiler] trace {attempt} holds no {what}")
    raise AssertionError(f"torch.profiler recorded no {what} in "
                         f"{PROFILE_TRIES} traces")


def _device_ms(fn, name: str, reps: int = 20) -> float:
    """Mean device time in ms of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn``, from ``torch.profiler``: the kernel
    alone, where a CUDA-event time of a small call is the host's
    enqueue time."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def named(evs):
        return [e for e in evs
                if e.device_type == DeviceType.CUDA and name in e.name]
    evs = named(_trace(run, named, name, cpu=False))
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / len(evs)


def phase_stft() -> dict:
    import torch
    from ctc_asr_tpu_torch.config import FeatureConfig, preset
    from ctc_asr_tpu_torch.ops import stft_cuda
    res = {"max_abs_err": 0.0, "library_ms": None, "cases": {}}
    mel = preset("conv_bilstm3").features
    cases = [("mel B=128 x 8 s", mel, 128, 128000, 1.0),
             ("mfcc B=4 x 1.5 s", FeatureConfig(feature_type="mfcc",
                                                n_mfcc=13, n_mels=40), 4,
              24000, 1.0),
             # the ladder's batches at its longest bucket (7.36 s): pr1's
             # MFCC (26 of 80 mels) and the conv rungs' log-mel
             ("mfcc 26 of 80 B=32 x 7.36 s (ladder pr1)",
              preset("pr1_mfcc_uni").features, 32, 117760, 1.0),
             ("mel B=32 x 7.36 s (ladder ds2 / ds3)", mel, 32, 117760, 1.0),
             # the synth runners' longest batches: e2e's MFCC (26 of 40
             # mels) at B=8 x 1.71 s, ds3's log-mel at B=8 x 2.79 s
             ("mfcc 26 of 40 B=8 x 1.71 s (synth e2e)",
              FeatureConfig(feature_type="mfcc", n_mfcc=26, n_mels=40), 8,
              27360, 1.0),
             ("mel B=8 x 2.79 s (synth ds3)", mel, 8, 44640, 1.0),
             # the decode slice's batches (evaluate) and requests (transcribe)
             ("mel B=16 x 3.52 s", mel, 16, 56320, 1.0),
             ("mel B=1 x 3.52 s", mel, 1, 56320, 1.0),
             # other FFT sizes: W=400 folded into 256 points, and 1024
             ("mel n_fft=256 B=4 x 1.5 s",
              dataclasses.replace(mel, n_fft=256), 4, 24000, 1.0),
             ("mel n_fft=1024 B=4 x 1.5 s",
              dataclasses.replace(mel, n_fft=1024), 4, 24000, 1.0),
             # amplitude ~1e-4 and an all-zero last third: the log
             # amplifies any error of a weak spectrum
             ("mel low energy B=4 x 1.5 s", mel, 4, 24000, 3e-4)]
    for i, (label, cfg, B, S, scale) in enumerate(cases):
        x = _speechlike(B, S, seed=B) * scale
        if scale != 1.0:
            x[:, 2 * S // 3:] = 0.0
        got = stft_cuda.stft_features(x, cfg)
        want = stft_cuda.stft_features_plain(x, cfg)
        exact = _features_f64(x, cfg)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        f64_err = (got.double() - exact).abs().max().item()
        plain_f64_err = (want.double() - exact).abs().max().item()
        del exact
        ms = cuda_ms(lambda: stft_cuda.stft_features(x, cfg), reps=20)
        plain_ms = cuda_ms(lambda: stft_cuda.stft_features_plain(x, cfg),
                           reps=20)
        dev_ms = _device_ms(lambda: stft_cuda.stft_features(x, cfg),
                            "stft_mel_kernel")
        bd, dft_bound_ms = _stft_bounds(cfg, B, S)
        log(f"[K1 stft] {label}: out {tuple(got.shape)} max_abs_err={err:.3e}"
            f" (tol {STFT_TOL}); against f64: kernel {f64_err:.3e}, plain "
            f"{plain_f64_err:.3e}; kernel {ms:.4f} ms (device {dev_ms:.4f} "
            f"ms) plain {plain_ms:.4f} ms bound {bd['bound_ms']:.4f} ms by "
            f"{bd['bound_by']} (the old DFT-as-matmul bound "
            f"{dft_bound_ms:.4f} ms)")
        if not torch.isfinite(got).all() or not err <= STFT_TOL:
            raise AssertionError(f"K1 {label}: max_abs_err {err} > {STFT_TOL}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        errs = {"max_abs_err": err, "max_abs_err_vs_f64": f64_err,
                "plain_max_abs_err_vs_f64": plain_f64_err}
        res["cases"][label] = {"ms": ms, "device_ms": dev_ms,
                               "plain_ms": plain_ms, **errs, **bd}
        if i == 0:   # the train step's shape gives the reported times
            part = _stft_power_ms(x, cfg)
            log(f"[K1 stft] {label}: torch.stft + abs()**2 (cuFFT, the DFT "
                f"power alone: a partial yardstick) {part:.4f} ms")
            res.update(ms=ms, plain_ms=plain_ms, stft_power_partial_ms=part,
                       max_abs_err_vs_f64=f64_err,
                       plain_max_abs_err_vs_f64=plain_f64_err, **bd)
    # an n_fft that is not a power of two: the direct-DFT kernel
    for i, (label, cfg, B, S) in enumerate((
            ("mel n_fft=400 B=128 x 8 s", dataclasses.replace(mel, n_fft=400),
             128, 128000),
            ("mel n_fft=320 B=4 x 1.5 s", dataclasses.replace(mel, n_fft=320),
             4, 24000))):
        x = _speechlike(B, S, seed=B + 1)
        d0 = stft_cuda.stft_features.dft_launches
        got = stft_cuda.stft_features(x, cfg)
        if stft_cuda.stft_features.dft_launches != d0 + 1:
            raise AssertionError(f"K1 {label}: the direct DFT did not launch")
        want = stft_cuda.stft_features_plain(x, cfg)
        exact = _features_f64(x, cfg)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        f64_err = (got.double() - exact).abs().max().item()
        plain_f64_err = (want.double() - exact).abs().max().item()
        del exact
        ms = cuda_ms(lambda: stft_cuda.stft_features(x, cfg), reps=20)
        plain_ms = cuda_ms(lambda: stft_cuda.stft_features_plain(x, cfg),
                           reps=20)
        dev_ms = _device_ms(lambda: stft_cuda.stft_features(x, cfg),
                            "stft_dft_kernel")
        bd, _ = _stft_bounds(cfg, B, S)
        log(f"[K1 stft dft] {label}: direct DFT, out {tuple(got.shape)} "
            f"max_abs_err={err:.3e} (tol {STFT_TOL}); against f64: kernel "
            f"{f64_err:.3e}, plain {plain_f64_err:.3e}; kernel {ms:.4f} ms "
            f"(device {dev_ms:.4f} ms) plain {plain_ms:.4f} ms bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}")
        if not torch.isfinite(got).all() or not err <= STFT_TOL:
            raise AssertionError(f"K1 {label}: max_abs_err {err} > {STFT_TOL}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["cases"][label] = {"ms": ms, "device_ms": dev_ms,
                               "plain_ms": plain_ms, "max_abs_err": err,
                               "max_abs_err_vs_f64": f64_err,
                               "plain_max_abs_err_vs_f64": plain_f64_err,
                               **bd}
        if i == 0:   # the direct route's entry in the kernels line
            res.update(dft_ms=ms, dft_device_ms=dev_ms,
                       dft_plain_ms=plain_ms, dft_max_abs_err=err,
                       dft_max_abs_err_vs_f64=f64_err,
                       dft_bound_ms=bd["bound_ms"])
    # geometries neither kernel takes: refused before any launch
    for label, cfg in (("n_fft=4096", dataclasses.replace(mel, n_fft=4096)),
                       ("n_fft=400, hop 100 ms",
                        dataclasses.replace(mel, n_fft=400, hop_ms=100.0))):
        n0 = stft_cuda.stft_features.launches
        try:
            stft_cuda.stft_features(x, cfg)
        except ValueError as e:
            log(f"[K1 stft] {label} refused before any launch: {e}")
        else:
            raise AssertionError(f"K1 took {label}")
        if stft_cuda.stft_features.launches != n0:
            raise AssertionError(f"K1 launched for {label}")
    return res


def _lstm_inputs(nd, T, B, H, lens, seed):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    G = 4 * H
    xproj = (0.5 * torch.randn(nd, T, B, G, generator=g)).to(torch.bfloat16)
    b = torch.zeros(nd, G)
    b[:, H:2 * H] = 1.0
    lim = (6.0 / (H + G)) ** 0.5
    wh = ((torch.rand(nd, H, G, generator=g) * 2 - 1) * lim).to(torch.bfloat16)
    lens = torch.as_tensor(lens, dtype=torch.int32)
    start = torch.stack([torch.zeros_like(lens), T - lens])[:nd]
    end = torch.stack([lens, torch.full_like(lens, T)])[:nd]
    return [t.cuda().contiguous() for t in (xproj, b, wh, start, end)]


def _cudnn_rnn_ms(cell: str, T, B, H, nd: int = 2):
    """The nearest PyTorch call to K2 / K3 (``cell="LSTM"``) or K4 / K5
    (``"GRU"``): ``torch.nn.LSTM`` / ``torch.nn.GRU`` (cuDNN) in bf16,
    [T, B, nd*H] -> [T, B, nd*H] (bidirectional for nd = 2), full-length
    rows. ``nn.GRU``
    has the kernels' gate order (r, z, n) and reset-after-product form
    ``n = tanh(x_n + r * (h @ w_n))``. Unlike the kernels the call
    includes the input projection. Returns (inference forward ms,
    backward ms = train forward + backward minus train forward). Timed
    here only; the port never calls it."""
    import torch
    torch.manual_seed(0)
    net = getattr(torch.nn, cell)(nd * H, H, bidirectional=nd == 2,
                                  device="cuda", dtype=torch.bfloat16)
    x = torch.randn(T, B, nd * H, device="cuda", dtype=torch.bfloat16)
    g = torch.randn(T, B, nd * H, device="cuda", dtype=torch.bfloat16)

    def infer():
        with torch.no_grad():
            net(x)

    def train_fwd():
        return net(x)[0]

    def train_fwd_bwd():
        net.zero_grad(set_to_none=True)
        net(x)[0].backward(g)

    fwd = cuda_ms(infer, reps=10)
    return fwd, cuda_ms(train_fwd_bwd, reps=10) - cuda_ms(train_fwd, reps=10)


def _lstm_bounds(nd, T, B, H):
    """K2: xproj read, h written (bf16), wh read once; 2*B*H*4H FLOPs a
    step and direction on the tensor cores. K3: g_out, gates and c read,
    dxproj written; the same FLOPs for dgates @ wh^T."""
    flops = 2.0 * nd * T * B * H * 4 * H
    cell = 2 * nd * T * B * H                       # bytes of one bf16 [.., H]
    wh = 2 * nd * H * 4 * H
    return (bound(4 * cell + cell + wh, flops, PEAK_BF16),
            bound(cell + 4 * cell + cell + 4 * cell + wh, flops, PEAK_BF16))


def _plan_text(plan) -> str:
    return (f"JT={plan.jt} BT={plan.bt} grid={plan.grid} cluster="
            f"{plan.cluster} = {plan.blocks} blocks, {plan.smem_bytes} B "
            f"shared")


def _barrier_us(plan, T: int) -> float:
    """µs a step of a kernel that only runs the T-1 step barriers of
    ``plan``'s grid (its launch included)."""
    import torch
    from ctc_asr_tpu_torch.ops import lstm_cuda
    dev = torch.device("cuda")
    ms = cuda_ms(lambda: lstm_cuda.barrier_probe(dev, plan, T - 1), reps=10)
    return ms * 1e3 / (T - 1)


def _outside(start, end, T):
    import torch
    t = torch.arange(T, device=start.device)[None, :, None]
    return (t < start[:, None, :]) | (t >= end[:, None, :])


def phase_lstm() -> dict:
    """K2 (inference) at every shape a main path gives it, held to the
    plain version; two runs must give equal bits at the timed shapes."""
    import torch
    from ctc_asr_tpu_torch.ops import lstm_cuda
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    res = {"max_abs_err": 0.0, "design": "persistent"}
    cases = [
        ("bi nd=2 B=128 T=399 H=512", 2, 399, 128, 512,
         np.concatenate([[399], rng.integers(200, 400, 127)]), ""),
        ("uni nd=1 B=37 T=50 H=512 ragged", 1, 50, 37, 512,
         np.concatenate([[50, 1, 2], rng.integers(1, 51, 34)]), None),
        # the ds3 width: H = 6 * 128 + 32, a ragged last K chunk
        ("bi nd=2 B=128 T=399 H=800", 2, 399, 128, 800,
         np.concatenate([[399], rng.integers(200, 400, 127)]), "_h800"),
        # the decode slice's own shapes: evaluate's batches, one request
        ("bi nd=2 B=16 T=175 H=800", 2, 175, 16, 800,
         np.concatenate([[175], rng.integers(60, 176, 15)]), None),
        ("bi nd=2 B=1 T=175 H=800", 2, 175, 1, 800, np.array([175]), None),
        # the serving and cli-train batch at the conv_bilstm3 width: 16
        # units a block, where B=128 above plans 32
        ("bi nd=2 B=16 T=200 H=512", 2, 200, 16, 512,
         np.concatenate([[200, 1], rng.integers(60, 201, 14)]), None),
        # one step: no barrier, no product
        ("bi nd=2 B=128 T=1 H=512", 2, 1, 128, 512,
         np.concatenate([[1, 0], np.ones(126, np.int64)]), None),
        # the ladder's batch of 32 at its longest bucket (7.36 s: 734
        # frames, 367 after the conv stride): pr1's uni-LSTM-256 and
        # ds3's BiLSTM-800
        ("uni nd=1 B=32 T=734 H=256 ragged", 1, 734, 32, 256,
         np.concatenate([[734, 1], rng.integers(300, 735, 30)]), "_b32_h256"),
        ("bi nd=2 B=32 T=367 H=800 ragged", 2, 367, 32, 800,
         np.concatenate([[367, 1], rng.integers(150, 368, 30)]), "_b32_h800"),
        # the synth runners' batches at their longest utterance: e2e's
        # uni-LSTM-256 (dense frontend, 171 frames), ds2's BiLSTM-256 at
        # B=16 and ds3's BiLSTM-800 at B=8 (2.7 / 2.79 s after the conv
        # stride)
        ("uni nd=1 B=8 T=171 H=256 ragged (synth e2e)", 1, 171, 8, 256,
         np.concatenate([[171, 1], rng.integers(18, 172, 6)]), "_synth_e2e"),
        ("bi nd=2 B=16 T=135 H=256 ragged (synth ds2)", 2, 135, 16, 256,
         np.concatenate([[135, 1], rng.integers(22, 136, 14)]), "_synth_ds2"),
        ("bi nd=2 B=8 T=140 H=800 ragged (synth ds3)", 2, 140, 8, 800,
         np.concatenate([[140, 1], rng.integers(18, 141, 6)]), "_synth_ds3"),
    ]
    for label, nd, T, B, H, lens, key in cases:
        args = _lstm_inputs(nd, T, B, H, lens, seed=nd)
        plan = lstm_cuda.plan_for(dev, nd, B, H)
        if plan is None:
            raise AssertionError(f"K2 {label}: no plan")
        want = lstm_cuda.lstm_seq_plain(*args).to(torch.bfloat16)
        outside = _outside(args[3], args[4], T)
        got = lstm_cuda.lstm_seq(*args)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # outputs past each row's window must be exactly zero
        zero_ok = bool((got.float().abs().amax(-1)[outside] == 0).all())
        ms = cuda_ms(lambda: lstm_cuda.lstm_seq(*args), reps=10)
        log(f"[K2 lstm] {label}: max_abs_err={err:.3e} "
            f"mean_abs_err={diff.mean().item():.3e} (tol {LSTM_TOL}) "
            f"zero_outside={zero_ok} kernel {ms:.4f} ms = "
            f"{ms * 1e3 / T:.2f} us a step")
        if not err <= LSTM_TOL or not zero_ok:
            raise AssertionError(f"K2 {label}: err {err} zero_ok {zero_ok}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        plain_ms = cuda_ms(lambda: lstm_cuda.lstm_seq_plain(*args), reps=3,
                           warmup=1)
        lib_fwd, lib_bwd = _cudnn_rnn_ms("LSTM", T, B, H, nd)
        b2, b3 = _lstm_bounds(nd, T, B, H)
        log(f"[K2 lstm] {label}: plan {_plan_text(plan)}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b2['bound_ms']:.4f} ms by {b2['bound_by']} (chain of {T} "
            f"steps), cuDNN nn.LSTM bf16 (with its input projection) forward "
            f"{lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms"
            + (f"; kernel / cuDNN forward = {ms / lib_fwd:.3f}"
               if H in (512, 800) and T > 1 else ""))
        if key is None:
            continue
        again = lstm_cuda.lstm_seq(*args)
        if not torch.equal(again, lstm_cuda.lstm_seq(*args)):
            raise AssertionError(f"K2 {label}: two runs differ in their bits")
        bar = _barrier_us(plan, T)
        log(f"[K2 lstm] {label}: two runs bit-equal; the step barrier alone "
            f"{bar:.2f} us a step")
        res.update({"ms" + key: ms, "plain_ms" + key: plain_ms,
                    "library_ms" + key: lib_fwd,
                    "bound_ms" + key: b2["bound_ms"],
                    "bound_by" + key: b2["bound_by"],
                    "step_us" + key: ms * 1e3 / T,
                    "barrier_us" + key: bar,
                    "plan" + key: dataclasses.asdict(plan)})
        res.setdefault("bwd", {})["library_ms" + key] = lib_bwd
        res["bwd"].update({k + key: v for k, v in b3.items()})
    return res


def _ctc_inputs(B, T, U, C, seed):
    """lp_z [T, B, S] of random logits, ragged lengths, row 0 an empty
    label, the last row infeasible (U > 3 labels in min(3, T) frames)."""
    import torch
    from ctc_asr_tpu_torch.ops import ctc_cuda
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, T, C, generator=g)
    labels = torch.randint(0, C - 1, (B, U), generator=g)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, dtype=torch.int32)
    llens = torch.randint(U // 2, U + 1, (B,), generator=g,
                          dtype=torch.int32)
    lens[0], llens[0] = T, 0
    lens[-1], llens[-1] = min(3, T), U
    z = ctc_cuda.extended_labels(labels, C - 1)
    lpz = torch.gather(torch.log_softmax(logits, -1), 2,
                       z[:, None, :].expand(-1, T, -1)).transpose(0, 1)
    return [t.contiguous().cuda() for t in
            (lpz, ctc_cuda.can_skip(z, C - 1), lens, (2 * llens).int())]


def _library_ctc_ms(B, T, U, C, seed):
    """``torch.nn.functional.ctc_loss`` forward and backward on the
    logits, labels and lengths of ``_ctc_inputs``: the one PyTorch call
    that computes K6's NLL and K7's gradient (it takes the log-probs
    and gathers the labels itself). Timed here only; the port never
    calls it."""
    import torch
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, T, C, generator=g)
    labels = torch.randint(0, C - 1, (B, U), generator=g)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, dtype=torch.int32)
    llens = torch.randint(U // 2, U + 1, (B,), generator=g,
                          dtype=torch.int32)
    lens[0], llens[0] = T, 0
    lens[-1], llens[-1] = 3, U
    lp = torch.log_softmax(logits, -1).transpose(0, 1).contiguous().cuda() \
        .requires_grad_(True)
    labels, lens, llens = labels.cuda(), lens.long().cuda(), llens.long().cuda()

    def fwd():
        return torch.nn.functional.ctc_loss(
            lp, labels, lens, llens, blank=C - 1, reduction="sum",
            zero_infinity=True)

    loss = fwd()
    fwd_ms = cuda_ms(fwd, reps=20)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(loss, lp, retain_graph=True),
                     reps=20)
    return fwd_ms, bwd_ms


def _ctc_small_cases() -> tuple[float, float]:
    """K6 / K7 against their plain versions at T = 1 to 12, which spans
    both kernels' rings (csrc/ctc.cu prefetches 8 rows ahead into 10
    slots): fewer rows than the prefetch, exactly it, and past one turn
    of the ring; and at ``cli train``'s batch (B=16, T'=175). K6's α
    must equal the plain version's bit for bit. Returns the largest α
    and gradient errors."""
    import torch
    from ctc_asr_tpu_torch.ops import ctc_cuda
    worst, worst_alpha = 0.0, 0.0
    cases = [(4, 1, 4), (4, 2, 4)]
    cases += [(6, T, 4 if T <= 8 else 5) for T in range(3, 13)]
    for B, T, U in cases + [(16, 175, 40)]:
        lpz, skip, lens, ends = _ctc_inputs(B, T, U, 29, seed=T)
        alphas, nll = ctc_cuda.ctc_alpha(lpz, skip, lens, ends)
        grad = ctc_cuda.ctc_beta_grad(lpz, alphas, skip, lens, ends, nll)
        palphas, pnll = ctc_cuda.ctc_alpha_plain(lpz, skip, lens, ends)
        pgrad = ctc_cuda.ctc_beta_grad_plain(lpz, palphas, skip, lens, ends,
                                             pnll)
        torch.cuda.synchronize()
        feas = pnll < 1e29
        alpha_err = (alphas - palphas).abs().max().item()
        nll_err = ((nll - pnll).abs() / pnll.abs().clamp_min(1.0))[feas] \
            .max().item()
        grad_err = (grad - pgrad)[:, feas].abs().max().item()
        ok = (alpha_err == 0.0 and nll_err <= CTC_NLL_RTOL
              and grad_err <= CTC_GRAD_ATOL
              and bool(torch.isfinite(grad).all()) and not bool(feas[-1])
              and nll[-1].item() >= 1e29)
        log(f"[K6/K7 ctc] B={B} T={T} U={U}: alpha max abs err="
            f"{alpha_err:.3e} (equal bits required) nll rel err="
            f"{nll_err:.3e} grad max abs err={grad_err:.3e} infeasible row "
            f"nll={nll[-1].item():.3e}{'' if ok else ' FAIL'}")
        if not ok:
            raise AssertionError(f"K6/K7 at B={B} T={T} U={U}")
        worst = max(worst, grad_err)
        worst_alpha = max(worst_alpha, alpha_err)
    return worst_alpha, worst


def _ctc_case(B: int, T: int, U: int, seed: int) -> dict:
    """K6 and K7 against their plain versions at [T, B, S = 2U + 1], with
    their times, device times, bounds and ``ctc_loss``'s times; raises on
    any disagreement. Returns {kernel: entry}."""
    import torch
    from ctc_asr_tpu_torch.ops import ctc_cuda
    lpz, skip, lens, ends = _ctc_inputs(B, T, U, 29, seed=seed)
    alphas, nll = ctc_cuda.ctc_alpha(lpz, skip, lens, ends)
    grad = ctc_cuda.ctc_beta_grad(lpz, alphas, skip, lens, ends, nll)
    palphas, pnll = ctc_cuda.ctc_alpha_plain(lpz, skip, lens, ends)
    pgrad = ctc_cuda.ctc_beta_grad_plain(lpz, palphas, skip, lens, ends,
                                         pnll)
    torch.cuda.synchronize()
    feas = pnll < 1e29
    lib_fwd, lib_bwd = _library_ctc_ms(B, T, U, 29, seed=seed)
    T, B, S = lpz.shape
    alpha_err = (alphas - palphas).abs().max().item()
    nll_err = ((nll - pnll).abs() / pnll.abs())[feas].max().item()
    grad_err = (grad - pgrad).abs().max().item()
    finite = bool(torch.isfinite(grad).all())
    infeasible_ok = bool(nll[-1] >= 1e29) and not bool(feas[-1])
    # lp_z read and alpha written (K7: lp_z and alpha read, the gradient
    # written); a 3-way log-sum-exp of ~12 f32 operations a state
    res = {
        "ctc_alpha": {
            "library_ms": lib_fwd,
            **bound(4 * (2 * T * B * S + B * S), 12 * T * B * S, PEAK_F32),
            "max_abs_err": (nll - pnll)[feas].abs().max().item(),
            "alpha_max_abs_err": alpha_err,
            "ms": cuda_ms(lambda: ctc_cuda.ctc_alpha(lpz, skip, lens, ends),
                          reps=20),
            "device_ms": _device_ms(lambda: ctc_cuda.ctc_alpha(
                lpz, skip, lens, ends), "ctc_alpha_kernel"),
            "plain_ms": cuda_ms(lambda: ctc_cuda.ctc_alpha_plain(
                lpz, skip, lens, ends), reps=3, warmup=1)},
        "ctc_beta_grad": {
            "library_ms": lib_bwd,
            **bound(4 * (3 * T * B * S + B * S), 14 * T * B * S, PEAK_F32),
            "max_abs_err": grad_err,
            "ms": cuda_ms(lambda: ctc_cuda.ctc_beta_grad(
                lpz, alphas, skip, lens, ends, nll), reps=20),
            "device_ms": _device_ms(lambda: ctc_cuda.ctc_beta_grad(
                lpz, alphas, skip, lens, ends, nll), "ctc_beta_grad_kernel"),
            "plain_ms": cuda_ms(lambda: ctc_cuda.ctc_beta_grad_plain(
                lpz, alphas, skip, lens, ends, nll), reps=3, warmup=1)},
    }
    log(f"[K6/K7 ctc] B={B} T={T} U={U} S={S}: alpha max abs err="
        f"{alpha_err:.3e} (equal bits required) nll rel err={nll_err:.3e} "
        f"(tol {CTC_NLL_RTOL}) grad max abs err={grad_err:.3e} (tol "
        f"{CTC_GRAD_ATOL}) grad finite={finite} infeasible row "
        f"nll={nll[-1].item():.3e}")
    for k, v in res.items():
        log(f"[K6/K7 ctc] B={B} T={T} {k}: kernel {v['ms']:.4f} ms (device "
            f"{v['device_ms']:.4f} ms) plain "
            f"{v['plain_ms']:.4f} ms bound {v['bound_ms']:.4f} ms by "
            f"{v['bound_by']} (chain of {T} steps) ctc_loss "
            f"{v['library_ms']:.4f} ms")
    if not (alpha_err == 0.0 and nll_err <= CTC_NLL_RTOL
            and grad_err <= CTC_GRAD_ATOL and finite and infeasible_ok):
        raise AssertionError(f"K6/K7 at B={B} T={T} U={U}: alpha err "
                             f"{alpha_err}, nll err {nll_err}, grad err "
                             f"{grad_err}, finite {finite}, infeasible "
                             f"{infeasible_ok}")
    return res


def phase_ctc() -> dict:
    """K6 / K7 at the train step's B=128, T'=399, U=96 (the kernels
    line's times) and at the ladder's longest: pr1 has no conv stride, so
    B=32 reaches T'=734 frames with U <= 72 (S <= 145)."""
    small_alpha_err, small_err = _ctc_small_cases()
    res = _ctc_case(128, 399, 96, seed=7)
    ladder = _ctc_case(32, 734, 72, seed=11)
    for k, v in res.items():
        v["ladder_case"] = {"shape": "B=32 T=734 U=72 S=145", **ladder[k]}
    res["ctc_alpha"]["alpha_max_abs_err"] = max(
        res["ctc_alpha"]["alpha_max_abs_err"], small_alpha_err,
        ladder["ctc_alpha"]["alpha_max_abs_err"])
    res["ctc_alpha"]["max_abs_err"] = max(
        res["ctc_alpha"]["max_abs_err"], ladder["ctc_alpha"]["max_abs_err"])
    res["ctc_beta_grad"]["max_abs_err"] = max(
        res["ctc_beta_grad"]["max_abs_err"], small_err,
        ladder["ctc_beta_grad"]["max_abs_err"])
    return res


def phase_lstm_train() -> dict:
    """K2 in residual mode and K3 at the train step's shape, at the ds3
    width, at cli train's batch of 16, at T=1, at the ladder's, the synth
    runners' and the benchmark's train batches, each held to the plain
    versions; two runs must give equal bits. K3's rows give its plan
    (clustered or not) and the chunks of dgates a block waits for a
    step."""
    import torch
    from ctc_asr_tpu_torch.ops import lstm_cuda
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    # B=16 is cli train's batch: it plans 16 units a block for both
    # kernels, where B=128 at H=512 plans 32 (K3's stacked product)
    # B=32 at the ladder's longest bucket: pr1's uni-LSTM-256, ds3's
    # BiLSTM-800
    # the synth runners' batches: e2e's uni-LSTM-256 at B=8, ds2's
    # BiLSTM-256 at B=16, ds3's BiLSTM-800 at B=8
    # the train cells' B=64 at their longer buckets (T' to 843): ds3's
    # BiLSTM-800 and ds2's BiLSTM-512
    cases = [("", 2, 399, 128, 512), ("_h800", 2, 399, 128, 800),
             (None, 2, 200, 16, 512), (None, 2, 1, 128, 512),
             ("_b32_h256", 1, 734, 32, 256), ("_b32_h800", 2, 367, 32, 800),
             ("_synth_e2e", 1, 171, 8, 256), ("_synth_ds2", 2, 135, 16, 256),
             ("_synth_ds3", 2, 140, 8, 800), ("_b64_h800", 2, 640, 64, 800),
             ("_b64_h512", 2, 640, 64, 512)]
    out = {"lstm_fwd_res": {"max_abs_err": 0.0},
           "lstm_bwd": {"max_abs_err": 0.0, "max_rel_err": 0.0,
                        "design": "persistent"}}
    for key, nd, T, B, H in cases:
        label = f"nd={nd} B={B} T={T} H={H}"
        # a full, a length-1 and an empty row among ragged ones
        lens = np.concatenate([[T, 1, 0],
                               rng.integers(T // 2, T + 1, B - 3)])
        xproj, b, wh, start, end = _lstm_inputs(nd, T, B, H, lens, seed=5)
        g = torch.Generator().manual_seed(6)
        gout = (0.1 * torch.randn(nd, T, B, H, generator=g)).to(
            torch.bfloat16).cuda()
        plans = [lstm_cuda.plan_for(dev, nd, B, H, backward=bw)
                 for bw in (False, True)]
        if None in plans:
            raise AssertionError(f"K2/K3 {label}: planned {plans}")
        ph, pc, pg = lstm_cuda.lstm_fwd_plain(xproj, b, wh, start, end)
        outside = _outside(start, end, T)
        h, c, gates = lstm_cuda.lstm_fwd(xproj, b, wh, start, end,
                                         residuals=True)
        dx, db = lstm_cuda.lstm_bwd(gout, gates, c, wh, start, end)
        dwh = lstm_cuda.dwh_from_seq(h, dx)
        # K3 and its plain version on the same inputs: the kernel's own
        # residuals
        pdx, pdb = lstm_cuda.lstm_bwd_plain(gout, gates, c, wh, start, end)
        pdwh = lstm_cuda.dwh_from_seq(h, pdx.to(torch.bfloat16))
        torch.cuda.synchronize()
        errs = {"h": (h.float() - ph).abs().max().item(),
                "c": (c.float() - pc).abs().max().item(),
                "gates": (gates.float() - pg).abs().max().item()}
        rel = {"dxproj": ((dx.float() - pdx).abs().max()
                          / pdx.abs().max()).item(),
               "db": ((db - pdb).abs().max() / pdb.abs().max()).item()}
        if T > 1:       # at T=1 dwh is h_{-1}^T @ dgates = 0
            rel["dwh"] = ((dwh.float() - pdwh.float()).abs().max()
                          / pdwh.float().abs().max()).item()
        zero_ok = bool(
            (h.float().abs().amax(-1)[outside] == 0).all()
            and (dx.float().abs().amax(-1)[outside] == 0).all())
        log(f"[K2+K3 lstm train] {label}: max abs err h/c/gates "
            f"{errs} (tol {LSTM_TOL}); relative to the largest: {rel} "
            f"(tol {BPTT_RTOL}); zero outside the windows={zero_ok}")
        if max(errs.values()) > LSTM_TOL or max(rel.values()) > BPTT_RTOL \
                or not zero_ok or not torch.isfinite(dx.float()).all():
            raise AssertionError(f"K2 residuals / K3 {label}: "
                                 f"{errs} {rel} zero_ok {zero_ok}")
        fwd_ms = cuda_ms(lambda: lstm_cuda.lstm_fwd(
            xproj, b, wh, start, end, residuals=True), reps=10)
        bwd_ms = cuda_ms(lambda: lstm_cuda.lstm_bwd(
            gout, gates, c, wh, start, end), reps=10)
        out["lstm_fwd_res"]["max_abs_err"] = max(
            out["lstm_fwd_res"]["max_abs_err"], *errs.values())
        out["lstm_bwd"]["max_abs_err"] = max(
            out["lstm_bwd"]["max_abs_err"],
            (dx.float() - pdx).abs().max().item())
        out["lstm_bwd"]["max_rel_err"] = max(
            out["lstm_bwd"]["max_rel_err"], *rel.values())
        again = lstm_cuda.lstm_fwd(xproj, b, wh, start, end, residuals=True)
        dx2, db2 = lstm_cuda.lstm_bwd(gout, gates, c, wh, start, end)
        if not all(torch.equal(x, y) for x, y in zip(
                (h, c, gates, dx, db), (*again, dx2, db2))):
            raise AssertionError(f"K2 residuals / K3 {label}: two runs "
                                 "differ in their bits")
        log(f"[K2 residual] {label}: plan {_plan_text(plans[0])}; kernel "
            f"{fwd_ms:.4f} ms = {fwd_ms * 1e3 / T:.2f} us a step")
        chunks = lstm_cuda.lstm_bwd_chunks(plans[1], H, B)
        log(f"[K3 bptt] {label}: plan {_plan_text(plans[1])}, {chunks} "
            f"chunks a step; kernel {bwd_ms:.4f} ms = "
            f"{bwd_ms * 1e3 / T:.2f} us a step; two runs bit-equal")
        if key is None:
            continue
        fwd_plain = cuda_ms(lambda: lstm_cuda.lstm_fwd_plain(
            xproj, b, wh, start, end), reps=3, warmup=1)
        bwd_plain = cuda_ms(lambda: lstm_cuda.lstm_bwd_plain(
            gout, gates, c, wh, start, end), reps=3, warmup=1)
        bar = _barrier_us(plans[1], T)
        log(f"[K2 residual] {label}: kernel {fwd_ms:.4f} ms, plain "
            f"{fwd_plain:.4f} ms; [K3 bptt] kernel {bwd_ms:.4f} ms, plain "
            f"{bwd_plain:.4f} ms; the step barrier alone {bar:.2f} us a step")
        out["lstm_fwd_res"].update({"ms" + key: fwd_ms,
                                    "plain_ms" + key: fwd_plain})
        out["lstm_bwd"].update({
            "ms" + key: bwd_ms, "plain_ms" + key: bwd_plain,
            "step_us" + key: bwd_ms * 1e3 / T, "barrier_us" + key: bar,
            "chunks" + key: chunks,
            "plan" + key: dataclasses.asdict(plans[1])})
    return out


def _gru_inputs(nd, T, B, H, lens, seed):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    G = 3 * H
    xproj = (0.5 * torch.randn(nd, T, B, G, generator=g)).to(torch.bfloat16)
    b = 0.1 * torch.randn(nd, G, generator=g)
    lim = (6.0 / (H + G)) ** 0.5
    wh = ((torch.rand(nd, H, G, generator=g) * 2 - 1) * lim).to(torch.bfloat16)
    lens = torch.as_tensor(lens, dtype=torch.int32)
    start = torch.stack([torch.zeros_like(lens), T - lens])[:nd]
    end = torch.stack([lens, torch.full_like(lens, T)])[:nd]
    return [t.cuda().contiguous() for t in (xproj, b, wh, start, end)]


def _gru_bounds(nd, T, B, H):
    """K4: xproj read (3 cells), h written, wh and the bias read once;
    with residuals the (r, z, n, hn) gates are written too; 2*B*H*3H
    FLOPs a step and direction on the tensor cores. K5: g_out, gates and
    h read, dxproj written; the same FLOPs for dhproj @ wh^T. The dhproj
    scratch is neither input nor output and is not counted."""
    flops = 2.0 * nd * T * B * H * 3 * H
    cell = 2 * nd * T * B * H                       # bytes of one bf16 [.., H]
    wh = 2 * nd * H * 3 * H + 4 * nd * 3 * H
    return (bound(3 * cell + cell + wh, flops, PEAK_BF16),
            bound(3 * cell + cell + 4 * cell + wh, flops, PEAK_BF16),
            bound(cell + 4 * cell + cell + 3 * cell + wh, flops, PEAK_BF16))


def _gate_err(got, want):
    """(r, z, n) lie in [-1, 1]; hn = h @ wh_n does not, and a bf16 ulp
    grows with it, so the error is taken relative to max(1, |want|)."""
    return ((got.float() - want).abs()
            / want.abs().clamp_min(1.0)).max().item()


def phase_gru() -> dict:
    """K4 (inference and residual mode) and K5 against their plain
    versions at every shape a main path gives them, with rows of length
    T, 1 and 0, each on the plan ``plan_recurrence`` gives; K4 and K5
    must each count one launch a call, and at B=128 two runs must give
    equal bits."""
    import torch
    from ctc_asr_tpu_torch.ops import gru_cuda, lstm_cuda
    from ctc_asr_tpu_torch.ops.lstm_cuda import dwh_from_seq
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    g = torch.Generator().manual_seed(15)
    # key "" is the train step's shape, whose times the kernels line
    # reports without a suffix
    cases = [("", 2, 399, 128, 512, "the train step"),
             ("_b16", 2, 200, 16, 512, "cli train and serving: JT=16"),
             ("_h800", 2, 175, 16, 800, "the ds3 width: a ragged last K "
              "chunk"),
             ("_h400", 2, 200, 128, 400, "H = 16 x odd: JT=32, K5's halves "
              "of K = 3H rounded up to whole atoms")]
    res = {"gru_fwd": {"max_abs_err": 0.0, "design": "persistent"},
           "gru_bwd": {"max_abs_err": 0.0, "max_rel_err": 0.0,
                       "design": "persistent"}}
    for key, nd, T, B, H, what in cases:
        label = f"nd={nd} B={B} T={T} H={H}"
        lens = np.concatenate([[T, 1, 0], rng.integers(T // 2, T + 1, B - 3)])
        args = _gru_inputs(nd, T, B, H, lens, seed=14 + B + H)
        xproj, b, wh, start, end = args
        gout = (0.1 * torch.randn(nd, T, B, H, generator=g)).to(
            torch.bfloat16).cuda()
        plans = [lstm_cuda.plan_for(dev, nd, B, H, 3, bw)
                 for bw in (False, True)]
        if None in plans or (H == 400 and {p.jt for p in plans} != {32}):
            raise AssertionError(f"K4/K5 {label}: plans {plans}")
        n4, n5 = gru_cuda.gru_fwd.launches, gru_cuda.gru_bwd.launches
        h_inf = gru_cuda.gru_seq(*args)
        h, gates = gru_cuda.gru_fwd(*args, residuals=True)
        dx, db = gru_cuda.gru_bwd(gout, gates, h, wh, start, end)
        calls = (gru_cuda.gru_fwd.launches - n4,
                 gru_cuda.gru_bwd.launches - n5)
        H2 = 2 * H
        dwh = dwh_from_seq(h, torch.cat(
            [dx[..., :H2], dx[..., H2:] * gates[..., :H]], -1))
        ph, pg = gru_cuda.gru_fwd_plain(*args)
        # K5 and its plain version on the same inputs: the kernel's residuals
        pdx, pdb = gru_cuda.gru_bwd_plain(gout, gates, h, wh, start, end)
        pdxb = pdx.to(torch.bfloat16)
        pdwh = dwh_from_seq(h, torch.cat(
            [pdxb[..., :H2], pdxb[..., H2:] * gates[..., :H]], -1))
        torch.cuda.synchronize()
        outside = _outside(start, end, T)
        zero_ok = bool((h.float().abs().amax(-1)[outside] == 0).all()
                       and (dx.float().abs().amax(-1)[outside] == 0).all())
        errs = {"h": (h.float() - ph).abs().max().item(),
                "gates": _gate_err(gates, pg)}
        rel = {
            "dxproj": ((dx.float() - pdx).abs().max()
                       / pdx.abs().max()).item(),
            "db": ((db - pdb).abs().max() / pdb.abs().max()).item(),
            "dwh": ((dwh.float() - pdwh.float()).abs().max()
                    / pdwh.float().abs().max()).item(),
        }
        same = torch.equal(h_inf, h)
        log(f"[K4+K5 gru] {label} ({what}; rows of length {T}, 1, 0 and "
            f"ragged): max abs err h / gates (r,z,n,hn) {errs} (tol "
            f"{LSTM_TOL}); relative to the largest: {rel} (tol "
            f"{BPTT_RTOL}); zero outside the windows={zero_ok}; inference h "
            f"equals residual-mode h={same}; launches a call {calls}")
        if max(errs.values()) > LSTM_TOL or max(rel.values()) > BPTT_RTOL \
                or not zero_ok or not same or calls != (2, 1) \
                or not torch.isfinite(dx.float()).all():
            raise AssertionError(f"K4 / K5 {label}: {errs} {rel} zero_ok "
                                 f"{zero_ok} same {same} calls {calls}")
        if B == 128:
            h2, gates2 = gru_cuda.gru_fwd(*args, residuals=True)
            dx2, db2 = gru_cuda.gru_bwd(gout, gates, h, wh, start, end)
            if not all(torch.equal(x, y) for x, y in zip(
                    (h, gates, dx, db), (h2, gates2, dx2, db2))):
                raise AssertionError(f"K4 / K5 {label}: two runs differ in "
                                     "their bits")
        fwd_ms = cuda_ms(lambda: gru_cuda.gru_seq(*args), reps=10)
        res_ms = cuda_ms(lambda: gru_cuda.gru_fwd(*args, residuals=True),
                         reps=10)
        bwd_ms = cuda_ms(lambda: gru_cuda.gru_bwd(gout, gates, h, wh, start,
                                                  end), reps=10)
        lib_fwd, lib_bwd = _cudnn_rnn_ms("GRU", T, B, H, nd)
        b4, b4r, b5 = _gru_bounds(nd, T, B, H)
        bars = [_barrier_us(p, T) for p in plans]
        log(f"[K4 gru] {label}: plan {_plan_text(plans[0])}; kernel "
            f"{fwd_ms:.4f} ms = {fwd_ms * 1e3 / T:.2f} us a step, with "
            f"residuals {res_ms:.4f} ms; bound {b4['bound_ms']:.4f} ms by "
            f"{b4['bound_by']} (with residuals {b4r['bound_ms']:.4f} ms by "
            f"{b4r['bound_by']}), chain of {T} steps; cuDNN nn.GRU bf16 (with "
            f"its input projection) forward {lib_fwd:.4f} ms; the step "
            f"barrier alone {bars[0]:.2f} us a step")
        log(f"[K5 gru bptt] {label}: plan {_plan_text(plans[1])}; kernel "
            f"{bwd_ms:.4f} ms = {bwd_ms * 1e3 / T:.2f} us a step; bound "
            f"{b5['bound_ms']:.4f} ms by {b5['bound_by']}, chain of {T} "
            f"steps; cuDNN nn.GRU backward {lib_bwd:.4f} ms; the step "
            f"barrier alone {bars[1]:.2f} us a step")
        res["gru_fwd"]["max_abs_err"] = max(res["gru_fwd"]["max_abs_err"],
                                            *errs.values())
        res["gru_bwd"]["max_abs_err"] = max(
            res["gru_bwd"]["max_abs_err"],
            (dx.float() - pdx).abs().max().item())
        res["gru_bwd"]["max_rel_err"] = max(res["gru_bwd"]["max_rel_err"],
                                            *rel.values())
        res["gru_fwd"].update({
            "ms" + key: fwd_ms, "residual_ms" + key: res_ms,
            "library_ms" + key: lib_fwd, "step_us" + key: fwd_ms * 1e3 / T,
            "barrier_us" + key: bars[0],
            "plan" + key: dataclasses.asdict(plans[0]),
            **{k + key: v for k, v in b4.items()},
            "residual_bound_ms" + key: b4r["bound_ms"],
            "residual_bound_by" + key: b4r["bound_by"]})
        res["gru_bwd"].update({
            "ms" + key: bwd_ms, "library_ms" + key: lib_bwd,
            "step_us" + key: bwd_ms * 1e3 / T, "barrier_us" + key: bars[1],
            "plan" + key: dataclasses.asdict(plans[1]),
            **{k + key: v for k, v in b5.items()}})
        if key in ("", "_h800"):
            fwd_plain = cuda_ms(lambda: gru_cuda.gru_seq_plain(*args), reps=3,
                                warmup=1)
            res["gru_fwd"]["plain_ms" + key] = fwd_plain
            msg = f"[K4 gru] {label}: plain {fwd_plain:.4f} ms"
            if key == "":
                bwd_plain = cuda_ms(lambda: gru_cuda.gru_bwd_plain(
                    gout, gates, h, wh, start, end), reps=3, warmup=1)
                res["gru_bwd"]["plain_ms"] = bwd_plain
                msg += f"; [K5 gru bptt] plain {bwd_plain:.4f} ms"
            log(msg)
    return res


def _bptt_test_case(nd, T, B, H, seed):
    """The inputs ``tests/test_torch_kernels._gru_case`` makes from
    ``seed``: xproj N(0, 1), wh U(-0.1, 0.1) (2.3x the Glorot limit at
    H=800), g_out N(0, 1), random row lengths with row 0 full."""
    import torch
    g = torch.Generator().manual_seed(seed)
    xproj = torch.randn(nd, T, B, 3 * H, generator=g).to(torch.bfloat16)
    b = 0.1 * torch.randn(nd, 3 * H, generator=g)
    wh = (0.2 * torch.rand(nd, H, 3 * H, generator=g) - 0.1).to(
        torch.bfloat16)
    lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    lens[0] = T
    start = torch.stack([torch.zeros_like(lens), T - lens])[:nd]
    end = torch.stack([lens, torch.full_like(lens, T)])[:nd]
    gout = torch.randn(nd, T, B, H, generator=g).to(torch.bfloat16)
    return [t.cuda().contiguous() for t in (xproj, b, wh, start, end, gout)]


# K5's db against the f64 BPTT: the kernel may be no further from it than
# the plain version is, by this much of the largest f64 db. Over the
# cases of F64_CASES on the H100 the largest excess read 2.4e-4, while
# both were 0.6e-3 to 1.2e-3 from f64 (PERF.md §6).
BPTT_F64_EXCESS = 5e-4
# (nd, T, B, H) and the seeds of ``_bptt_test_case``: the failing shape
# of the cuda tests (B=1: db is one row's sum, no averaging over rows)
# first, at its own seed T + H, then the neighbours in B and H
F64_CASES = (((2, 60, 1, 800), (860, 1, 2, 3, 4, 5, 6, 7, 8, 9)),
             ((2, 40, 16, 800), (856, 1, 2, 3)),
             ((2, 40, 128, 512), (552, 1, 2)),
             ((2, 60, 1, 512), (572, 1, 2, 3)))


def phase_gru_f64(cases=F64_CASES) -> dict:
    """K5 and its plain version, both against the f64 BPTT on the same
    bf16 residuals (``gru_bwd_plain(exact=True)``: nothing rounded), with
    the plain version on the CPU as a second summation order. Kernel and
    plain version both round dhproj to bf16 at every step, so each is as
    far from f64 as that rounding carries along the chain, and two
    summation orders differ by about as much as either is from f64. The
    kernel must be no further from f64 than the plain version on the card
    is, by more than BPTT_F64_EXCESS. Errors are relative to the largest
    f64 value."""
    import torch
    from ctc_asr_tpu_torch.ops import gru_cuda

    def err(a, b_, scale):
        return ((a.double().cuda() - b_.double().cuda()).abs().max()
                / scale).item()

    out = {"kernel": 0.0, "plain": 0.0, "excess": -1.0}
    for (nd, T, B, H), seeds in cases:
        for seed in seeds:
            xproj, b, wh, start, end, gout = _bptt_test_case(nd, T, B, H,
                                                             seed)
            h, gates = gru_cuda.gru_fwd(xproj, b, wh, start, end,
                                        residuals=True)
            args = (gout, gates, h, wh, start, end)
            runs = {"kernel": gru_cuda.gru_bwd(*args),
                    "plain": gru_cuda.gru_bwd_plain(*args),
                    "plain_cpu": gru_cuda.gru_bwd_plain(
                        *(a.cpu() for a in args))}
            ex_dx, ex_db = gru_cuda.gru_bwd_plain(*args, exact=True)
            dx_scale = ex_dx.abs().max().item()
            db_scale = ex_db.abs().max().item()
            db = {k: err(v[1], ex_db, db_scale) for k, v in runs.items()}
            dx = {k: err(v[0], ex_dx, dx_scale) for k, v in runs.items()}
            db["kernel_vs_plain"] = err(runs["kernel"][1], runs["plain"][1],
                                        db_scale)
            db["plain_vs_plain_cpu"] = err(runs["plain"][1],
                                           runs["plain_cpu"][1], db_scale)
            label = f"nd={nd} T={T} B={B} H={H} seed={seed}"
            log(f"[K5 gru bptt f64] {label}: db error relative to the "
                f"largest f64 db {db}; dxproj {dx}")
            out["kernel"] = max(out["kernel"], db["kernel"])
            out["plain"] = max(out["plain"], db["plain"])
            out["excess"] = max(out["excess"], db["kernel"] - db["plain"])
            if db["kernel"] > db["plain"] + BPTT_F64_EXCESS:
                raise AssertionError(f"K5 {label}: further from the f64 "
                                     f"BPTT than the plain version: {db}")
    log(f"[K5 gru bptt f64] largest db error against f64: kernel "
        f"{out['kernel']}, plain {out['plain']}; largest excess of the "
        f"kernel's over the plain version's {out['excess']} (limit "
        f"{BPTT_F64_EXCESS})")
    return out


def beam_agreement(got, want) -> dict:
    """K8's N-best output against the plain version's on the same
    logits. Raises unless the live entries' scores agree within
    BEAM_SCORE_RTOL, no N-best list holds a live prefix twice, and ids
    and lengths are identical in every row whose two best final scores
    differ by more than BEAM_TIE. Returns the rows excused by that tie
    rule and the largest score error."""
    import torch
    (ids, lens, sc), (pids, plens, psc) = got, want
    live = psc > -1e29
    if not torch.equal(sc > -1e29, live):
        raise AssertionError("K8: live beams differ from the plain version")
    abs_err = (sc - psc).abs()[live].max().item()
    rel = ((sc - psc).abs() / psc.abs().clamp_min(1.0))[live].max().item()
    if not rel <= BEAM_SCORE_RTOL:
        raise AssertionError(f"K8: N-best score error {rel} > "
                             f"{BEAM_SCORE_RTOL}")
    pos = torch.arange(ids.shape[2], device=ids.device)
    same = ((ids == pids) | (pos >= plens[:, :, None])).all(-1) \
        & (lens == plens)
    rows_same = (same | ~live).all(dim=1)
    margin = psc[:, 0] - psc[:, 1]
    bad = ~rows_same & (margin > BEAM_TIE)
    if bad.any():
        raise AssertionError(f"K8: rows {bad.nonzero().flatten().tolist()} "
                             "differ from the plain version without a "
                             "near-tie")
    ids_c, lens_c, live_c = ids.cpu(), lens.cpu(), live.cpu()
    for b in range(ids.shape[0]):
        rows = [tuple(ids_c[b, k, :int(lens_c[b, k])].tolist())
                for k in range(ids.shape[1]) if live_c[b, k]]
        if len(set(rows)) != len(rows):
            raise AssertionError(f"K8: duplicate live prefix in row {b}")
    return {"excused": int((~rows_same).sum()), "max_abs_err": abs_err,
            "max_rel_err": rel}


def _beam_bound(lens, B, K, C, U, kout, table_bytes):
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


def phase_select() -> dict:
    """K8's selection alone (``beam_select_probe``) on every crafted case
    of ``tests/beam_select_cases.py``: the K best keys and flat indices
    must equal a stable sort's. Then its own time at the kernel's shapes:
    one block fills the keys and selects R times in one launch; the time
    of R over that of 1, a rep, less the same without the selection."""
    import torch
    from ctc_asr_tpu_torch.ops import beam_cuda
    sys.path.append(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from beam_select_cases import SELECT_CASES, select_case
    for name, N, K in SELECT_CASES:
        scores, h1 = (torch.from_numpy(a) for a in select_case(name, N, K))
        keys, flat = beam_cuda.select_top_k_probe(scores.cuda(), h1.cuda(),
                                                  K)
        pkeys, pflat = beam_cuda.select_top_k_probe(scores, h1, K)
        if not (torch.equal(keys.cpu(), pkeys)
                and torch.equal(flat.cpu(), pflat)):
            raise AssertionError(f"K8 selection, {name} (N={N}, K={K}): "
                                 "differs from the stable sort")
    log(f"[K8 select] {len(SELECT_CASES)} crafted cases: the selection "
        "alone equals the stable sort exactly")
    res, reps = {}, 201
    for N, K, C in ((1856, 64, 29), (1024, 512, 2), (14848, 512, 29)):
        scores, h1 = (torch.from_numpy(a).cuda()
                      for a in select_case("quantized", N, K))

        def per_rep(select):
            t = [cuda_ms(lambda: beam_cuda._select_probe(
                scores, h1, K, reps=r, select=select), reps=10)
                for r in (1, reps)]
            return 1e3 * (t[1] - t[0]) / (reps - 1)
        fill = per_rep(False)
        us = per_rep(True) - fill
        log(f"[K8 select] N={N} (K={K}, C={C}): the selection alone "
            f"{us:.3f} µs (its block barriers: one after the warp sorts and "
            f"one a merge level, by select_top in csrc/beam.cu), the fill "
            f"of its keys {fill:.3f} µs")
        res[f"K={K} C={C}"] = us
    return res


def _beam_logits(B: int, T: int, seed: int):
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((B, T, 29)) * 2).astype(np.float32)).cuda()


def phase_beam() -> dict:
    """K8 against its plain version on seeded logits at B=128, T=400 in
    four modes, then at the decode path's and the synth runners' own
    shapes."""
    import torch
    from ctc_asr_tpu_torch.ops import beam_cuda
    B, T, C, K = 128, 400, 29, 64
    rng = np.random.default_rng(8)
    logits = torch.from_numpy(
        (rng.standard_normal((B, T, C)) * 2).astype(np.float32)).cuda()
    lens_np = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lens_np[0], lens_np[-1] = T, 0
    lens = torch.from_numpy(lens_np).cuda()
    g = torch.Generator(device="cuda").manual_seed(9)
    tables = {order: torch.log_softmax(
        2 * torch.randn(28 ** (order - 1), 28, generator=g, device="cuda"),
        dim=-1) for order in (4, 5)}
    fused = dict(lm_weight=0.8, word_bonus=1.0)
    modes = [("acoustic", None, {}, True),
             ("order-4 fusion", 4, fused, True),
             ("order-5 table", 5, fused, False),
             ("order-4 fusion, N-best emit", 4, fused, False)]
    res = {"max_abs_err": 0.0, "library_ms": None, "modes": {}}
    for label, order, kw, time_plain in modes:
        table = tables.get(order)
        # U = T, so that no prefix is cut at the decode buffer's end
        # (cut prefixes of different beams can coincide)
        kw = dict(kw, beam_width=K, lm_table=table, max_decode_len=T)
        nbest_emit = label.endswith("emit")
        got = beam_cuda.beam_search_decode_cuda(logits, lens,
                                                return_nbest=True, **kw)
        want = beam_cuda.beam_search_decode_plain(logits, lens,
                                                  return_nbest=True, **kw)
        torch.cuda.synchronize()
        agree = beam_agreement(got, want)
        best = beam_cuda.beam_search_decode_cuda(logits, lens, **kw)
        if not (torch.equal(best[0], got[0][:, 0])
                and torch.equal(best[1], got[1][:, 0])):
            raise AssertionError(f"K8 {label}: best differs from N-best[0]")
        if int(got[1][-1].max()) != 0:
            raise AssertionError("K8: the zero-length row emitted characters")
        ms = cuda_ms(lambda: beam_cuda.beam_search_decode_cuda(
            logits, lens, return_nbest=nbest_emit, **kw), reps=10)
        plain_ms = cuda_ms(lambda: beam_cuda.beam_search_decode_plain(
            logits, lens, **kw), reps=2, warmup=0) if time_plain else None
        bd = _beam_bound(lens_np, B, K, C, T, K if nbest_emit else 1,
                         0 if table is None else table.numel() * 4)
        log(f"[K8 beam] {label}: B={B} T={T} C={C} K={K}: rows excused by "
            f"the tie rule {agree['excused']}, N-best score max abs err "
            f"{agree['max_abs_err']:.3e} rel {agree['max_rel_err']:.3e} (tol "
            f"{BEAM_SCORE_RTOL}); kernel {ms:.4f} ms = {1e3 * ms / T:.2f} µs "
            f"a step; plain "
            + (f"{plain_ms:.1f} ms" if time_plain else "not timed")
            + f", bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} (chain "
            f"of up to {T} steps)")
        res["modes"][label] = {"ms": ms, "us_per_step": 1e3 * ms / T,
                               "plain_ms": plain_ms, **agree, **bd}
        res["max_abs_err"] = max(res["max_abs_err"], agree["max_abs_err"])
    res.update({k: res["modes"]["order-4 fusion"][k]
                for k in ("ms", "us_per_step", "plain_ms", "bound_ms",
                          "bound_by")})
    # one request, as ``cli transcribe`` gives it, then the decode path's
    # own shapes: a batch of ``evaluate`` (B=16, 175 frames, the whole
    # beam emitted for rescoring) and a ~1 s request; every row full.
    # Then the synth runners' batches at their longest utterance, ragged:
    # e2e (B=8, 171 frames), ds2 and holdout (B=16, 135 / 189 frames) at
    # beam 16, synth_lm's order-3 fusion with the whole beam emitted for
    # its N-best rescoring, and ds3 at beam 64 (B=8, 140 frames)
    tables[3] = torch.log_softmax(
        2 * torch.randn(28 ** 2, 28, generator=g, device="cuda"), dim=-1)
    full = dict(fused, lm_order=4, beam_width=K)
    synth = dict(beam_width=16, lm_order=None)
    shapes = [("B=1 T=400 order-4 fusion", logits[:1], lens[:1], full,
               False, False),
              ("B=16 T=175 order-4 fusion, N-best emit",
               _beam_logits(16, 175, 10), None, full, True, False),
              ("B=1 T=100 order-4 fusion", _beam_logits(1, 100, 11), None,
               full, False, False),
              ("B=8 T=171 K=16 acoustic (synth e2e)",
               _beam_logits(8, 171, 12), 171, synth, False, True),
              ("B=16 T=135 K=16 acoustic (synth ds2)",
               _beam_logits(16, 135, 13), 135, synth, False, True),
              ("B=16 T=189 K=16 acoustic (synth holdout)",
               _beam_logits(16, 189, 14), 189, synth, False, True),
              ("B=16 T=135 K=16 order-3 fusion, N-best emit (synth lm)",
               _beam_logits(16, 135, 15), 135,
               dict(lm_weight=0.6, word_bonus=0.5, lm_order=3,
                    beam_width=16), True, True),
              ("B=8 T=140 K=64 acoustic (synth ds3)",
               _beam_logits(8, 140, 16), 140,
               dict(beam_width=K, lm_order=None), False, True)]
    res["shapes"] = {}
    for label, lg, ln, mode, nbest_emit, time_plain in shapes:
        Bs, Ts = lg.shape[:2]
        if ln is None:
            ln = torch.full((Bs,), Ts, dtype=torch.int32, device="cuda")
        elif isinstance(ln, int):   # ragged: row 0 full, row 1 one frame
            r = np.random.default_rng(ln)
            ln_np = r.integers(Ts // 8, Ts + 1, Bs).astype(np.int32)
            ln_np[0], ln_np[1] = Ts, 1
            ln = torch.from_numpy(ln_np).cuda()
        mode = dict(mode)
        order, Ks = mode.pop("lm_order"), mode["beam_width"]
        table = tables.get(order)
        kw = dict(mode, lm_table=table, max_decode_len=Ts)
        agree = beam_agreement(
            beam_cuda.beam_search_decode_cuda(lg, ln, return_nbest=True,
                                              **kw),
            beam_cuda.beam_search_decode_plain(lg, ln, return_nbest=True,
                                               **kw))
        ms = cuda_ms(lambda: beam_cuda.beam_search_decode_cuda(
            lg, ln, return_nbest=nbest_emit, **kw), reps=10)
        plain_ms = cuda_ms(lambda: beam_cuda.beam_search_decode_plain(
            lg, ln, return_nbest=nbest_emit, **kw), reps=2, warmup=0) \
            if time_plain else None
        bd = _beam_bound(ln.cpu().numpy(), Bs, Ks, C, Ts,
                         Ks if nbest_emit else 1,
                         0 if table is None else table.numel() * 4)
        log(f"[K8 beam] {label}: rows excused {agree['excused']}, score rel "
            f"err {agree['max_rel_err']:.3e}; kernel {ms:.4f} ms = "
            f"{1e3 * ms / Ts:.2f} µs a step; plain "
            + (f"{plain_ms:.1f} ms" if time_plain else "not timed")
            + f"; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
        res["shapes"][label] = {"ms": ms, "us_per_step": 1e3 * ms / Ts,
                                "plain_ms": plain_ms, **agree, **bd}
        res["max_abs_err"] = max(res["max_abs_err"], agree["max_abs_err"])
    res["ms_b1"] = res["shapes"]["B=1 T=400 order-4 fusion"]["ms"]
    return res


# ---------------------------------------------------------------------------
# the frontend convs (no TPU kernel: the reference leaves them to XLA)
# ---------------------------------------------------------------------------

# The forms in bf16 against the f32 2-D conv (TF32 off), each error over
# the f32 result's largest magnitude. bf16 rounds the operands and conv
# 1's output (2**-9 relative each); a sum of hundreds to thousands of such
# products with random signs lands within a few of those (measured 4.9e-3
# for every form). Conv 1's kernel gradient also sums x * dy over the
# positions where the clipped ReLU passes, and bf16 moves ~0.1% of conv
# 1's outputs across 0: those flips, with random signs, shift the sum by
# ~sqrt(0.001) of its size (measured 3.7e-2 for the bf16 2-D cuDNN conv,
# 3.7e-2 for the full band, on the H100).
CONV_VALUE_RTOL = 2e-2
CONV_GRAD_RTOL = 6e-2


CONV_LEAVES = ("conv 1 w", "conv 1 b", "conv 2 w", "conv 2 b")


def _rel_err(got, want) -> float:
    """Max abs error over the reference's largest magnitude."""
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _device_ms_per_call(fn, reps: int = 7) -> list:
    """Device time of each of ``reps`` calls of ``fn`` in ms, from
    ``torch.profiler``: the kernels and copies inside each call's
    device-side range, after one traced call that is thrown away
    (``_profile_step``'s method, per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    fn()
    torch.cuda.synchronize()

    def run():
        fn()
        torch.cuda.synchronize()
        for i in range(reps):
            with record_function(f"timed call {i}"):
                fn()
            torch.cuda.synchronize()

    # a range's device-side marks start at its first kernel; kernels
    # launched by the autograd thread fall outside them, so a call owns
    # every kernel from its first mark to the next call's (the calls are
    # separated by a synchronize)
    def first_marks(evs):
        marks: dict = {}
        for e in evs:
            if e.name.startswith("timed call ") \
                    and e.device_type == DeviceType.CUDA:
                marks[e.name] = min(marks.get(e.name, e.time_range.start),
                                    e.time_range.start)
        return sorted(marks.values())
    evs = _trace(run, lambda evs: len(first_marks(evs)) == reps,
                 f"device-side mark of each of {reps} timed calls")
    starts = first_marks(evs)
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("timed call ")]
    ends = starts[1:] + [float("inf")]
    return [sum(k.time_range.elapsed_us() for k in kernels
                if a <= k.time_range.start < b) / 1e3
            for a, b in zip(starts, ends)]


def _conv_flops(form: str, w_shape, B, T_out, F_in, sf) -> float:
    """Multiply-adds x 2 of one conv's forward in ``form``: the true 2-D
    conv, the full band (every input row against every output column) or
    the blocked band (each block's slab against its gfo columns; the
    full band where no 128-column tiling exists)."""
    from ctc_asr_tpu_torch.models.layers import _pick_gfo, same_pad
    kt, kf, cin, cout = w_shape
    f_out = same_pad(F_in, kf, sf)[0]
    gfo = _pick_gfo(f_out, cout)
    if form == "2-D":
        k, n = kt * kf * cin, f_out * cout
    elif form == "full band" or gfo is None:
        k, n = kt * F_in * cin, f_out * cout
    else:
        k = kt * min((gfo - 1) * sf + kf, F_in) * cin
        n = f_out * cout
    return 2.0 * B * T_out * k * n


def _blocked_grouped_apply(params, x, strides, compute_dtype):
    """The blocked form as ONE grouped 1-D time conv (groups = blocks)
    over the blocks' overlapping slabs gathered side by side. Timed here
    only, beside the port's one conv a distinct slab."""
    import torch
    import torch.nn.functional as F
    from ctc_asr_tpu_torch.models import layers as L
    w = params["w"]
    kt, kf, cin, cout = w.shape
    B, T, F_in, _ = x.shape
    st, sf = strides
    f_out = L.same_pad(F_in, kf, sf)[0]
    starts, mats = L._blocked_bands(w, F_in, sf, L._pick_gfo(f_out, cout))
    mats = torch.stack(mats)
    G, _, K, N = mats.shape
    rows = torch.as_tensor([s + r for s in starts for r in range(K // cin)],
                           device=x.device)
    slabs = x.to(compute_dtype)[:, :, rows].reshape(B, T, G * K)
    wt = mats.to(compute_dtype).permute(0, 3, 2, 1).reshape(G * N, K, kt, 1)
    T_out, lo, hi = L.same_pad(T, kt, st)
    x4 = F.pad(slabs, (0, 0, lo, hi)).unsqueeze(2).permute(0, 3, 1, 2)
    y = F.conv2d(x4.contiguous(memory_format=torch.channels_last),
                 wt.contiguous(memory_format=torch.channels_last),
                 stride=(st, 1), groups=G)     # as layers._time_conv does
    y = y.permute(0, 2, 3, 1).reshape(B, T_out, f_out, cout)
    return y.float() + params["b"]


def _blocked_loop_apply(params, x, strides, compute_dtype):
    """The reference's blocked form as written (``_conv_blocked_fwd_impl``
    there): one 1-D time conv a block, then a concatenation. Timed here
    only, beside the port's one conv a distinct slab."""
    import torch
    from ctc_asr_tpu_torch.models import layers as L
    w = params["w"]
    kt, kf, cin, cout = w.shape
    B, T, F_in, _ = x.shape
    st, sf = strides
    f_out = L.same_pad(F_in, kf, sf)[0]
    starts, mats = L._blocked_bands(w, F_in, sf, L._pick_gfo(f_out, cout))
    gin_f = mats[0].shape[1] // cin
    xb = x.to(compute_dtype)
    y = torch.cat([L._time_conv(xb[:, :, s:s + gin_f].reshape(B, T, -1),
                                m.to(compute_dtype).permute(2, 1, 0), st)
                   for s, m in zip(starts, mats)], -1)
    return y.float().reshape(B, y.shape[1], f_out, cout) + params["b"]


def _full_band_taps_apply(params, x, strides, compute_dtype):
    """The full band as kt matmuls, one a time tap, on strided time
    views, summed in f32 (each tap's product rounded to the compute
    dtype first). Timed here only."""
    import torch
    import torch.nn.functional as F
    from ctc_asr_tpu_torch.models import layers as L
    w = params["w"]
    kt, cout = w.shape[0], w.shape[3]
    B, T, F_in, C = x.shape
    st, sf = strides
    Wb = L._band_matrices(w, F_in, sf).to(compute_dtype)
    T_out, lo, hi = L.same_pad(T, kt, st)
    xp = F.pad(x.reshape(B, T, F_in * C).to(compute_dtype), (0, 0, lo, hi))
    y = sum(torch.matmul(xp[:, k:k + st * (T_out - 1) + 1:st], Wb[k]).float()
            for k in range(kt))
    return y.reshape(B, T_out, -1, cout) + params["b"]


def _conv_chain(fn, p1, p2, x, cfg, cdt):
    """conv 1 -> clipped ReLU -> conv 2, as the encoder's frontend."""
    from ctc_asr_tpu_torch.models.layers import clipped_relu
    s1, s2 = cfg.conv_strides
    y = clipped_relu(fn(p1, x, s1, cdt), cfg.relu_clip)
    return fn(p2, y, s2, cdt)


def phase_conv() -> dict:
    """The ``conv_bilstm3`` frontend (two SAME convs, 1 -> 32 -> 32
    channels) at the train step's B=128 x 8 s (T=798 frames, T'=399) and
    the serving batch B=16 x 350 frames (T'=175, forward only), in the
    three forms the encoder selects (the 2-D cuDNN conv, the full band
    and the blocked band) and, at the train shape, three more ways of
    computing the banded time conv (the reference's one conv a block; one
    grouped conv over the gathered slabs; the full band as kt matmuls).
    Each: the profiler's device time, median of
    7 calls, with the CUDA-event median beside it, forward alone and
    forward + backward (gradients of both kernels and biases, and so of
    conv 2's input); the error of the output and the gradients against
    the f32 2-D conv; the FLOP bound at the bf16 peak."""
    import torch
    from ctc_asr_tpu_torch.config import preset
    from ctc_asr_tpu_torch.models import layers as L
    from ctc_asr_tpu_torch.models.encoder import init_params
    mcfg = preset("conv_bilstm3").model
    params = init_params(mcfg, 80, torch.Generator().manual_seed(21))
    p1 = {k: params[f"frontend/0/{k}"].cuda() for k in ("w", "b")}
    p2 = {k: params[f"frontend/1/{k}"].cuda() for k in ("w", "b")}
    for p in (p1, p2):   # the encoder's biases start at 0; test them too
        p["b"] = 0.1 * torch.randn(p["b"].shape, device="cuda",
                                   generator=torch.Generator(
                                       "cuda").manual_seed(22))
    leaves = [p1["w"], p1["b"], p2["w"], p2["b"]]
    forms = {"2-D": L.conv2d_apply, "full band": L.conv2d_matmul_apply,
             "blocked": L.conv2d_blocked_apply}
    extra = {"blocked, one conv a block (the reference's loop)":
             _blocked_loop_apply,
             "blocked, one grouped conv": _blocked_grouped_apply,
             "full band as kt matmuls": _full_band_taps_apply}
    cdt = torch.bfloat16
    res: dict = {"train": {}, "serve": {}}
    for shape, B, T in (("train", 128, 798), ("serve", 16, 350)):
        rng = np.random.default_rng(23)
        x = torch.from_numpy(rng.standard_normal((B, T, 80)).astype(
            np.float32))[..., None].cuda()
        (kt1, _, _, _), (kt2, _, _, _) = p1["w"].shape, p2["w"].shape
        T1 = -(-T // mcfg.conv_strides[0][0])
        T2 = -(-T1 // mcfg.conv_strides[1][0])
        ref_w = [t.detach().requires_grad_() for t in leaves]
        rp1 = {"w": ref_w[0], "b": ref_w[1]}
        rp2 = {"w": ref_w[2], "b": ref_w[3]}
        want = _conv_chain(L.conv2d_apply, rp1, rp2, x, mcfg, torch.float32)
        g = torch.randn(want.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(24))
        want_g = torch.autograd.grad(want, ref_w, g)
        want = want.detach()
        todo = dict(forms, **(extra if shape == "train" else {}))
        for name, fn in todo.items():
            w_ = [t.detach().requires_grad_() for t in leaves]
            q1, q2 = {"w": w_[0], "b": w_[1]}, {"w": w_[2], "b": w_[3]}
            got = _conv_chain(fn, q1, q2, x, mcfg, cdt)
            got_g = torch.autograd.grad(got, w_, g)
            err = _rel_err(got.detach(), want)
            gerrs = [_rel_err(a, b) for a, b in zip(got_g, want_g)]
            gerr = max(gerrs)
            del got, got_g

            def fwd():
                with torch.no_grad():
                    _conv_chain(fn, q1, q2, x, mcfg, cdt)

            def fwd_bwd():
                torch.autograd.grad(_conv_chain(fn, q1, q2, x, mcfg, cdt),
                                    w_, g)

            form = "2-D" if name == "2-D" else (
                "full band" if "full" in name else "blocked")
            f1 = _conv_flops(form, p1["w"].shape, B, T1, 80,
                             mcfg.conv_strides[0][1])
            f2 = _conv_flops(form, p2["w"].shape, B, T2, 40,
                             mcfg.conv_strides[1][1])
            io = 4 * (x.numel() + want.numel()
                      + sum(t.numel() for t in leaves))
            entry = {"max_rel_err": err, "grad_max_rel_err": gerr,
                     "grad_rel_errs": dict(zip(CONV_LEAVES, gerrs)),
                     "fwd_gflop": (f1 + f2) / 1e9}
            runs = (("fwd", fwd, f1 + f2, io),) if shape == "serve" else (
                ("fwd", fwd, f1 + f2, io),
                ("fwd_bwd", fwd_bwd, 2 * f1 + 3 * f2,
                 2 * io + 4 * g.numel()))
            for tag, call, flops, n_bytes in runs:
                dev = _device_ms_per_call(call)
                ev = cuda_ms(call, reps=7)
                bd = bound(n_bytes, flops, PEAK_BF16)
                entry[tag] = {"device_ms": statistics.median(dev),
                              "device_ms_runs": dev, "event_ms": ev,
                              "gflop": flops / 1e9, **bd}
                log(f"[conv] {shape} B={B} x {T} frames, {name}, {tag}: "
                    f"device {statistics.median(dev):.4f} ms (median of 7; "
                    f"runs {', '.join(f'{v:.4f}' for v in dev)}), CUDA "
                    f"events {ev:.4f} ms; {flops / 1e9:.1f} GFLOP, bound "
                    f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({flops / 1e9 / statistics.median(dev):.1f} TFLOP/s)")
            log(f"[conv] {shape} {name}: max error against the f32 2-D conv "
                f"{err:.3e} of the largest output (limit "
                f"{CONV_VALUE_RTOL}); gradients "
                + ", ".join(f"{k} {v:.3e}" for k, v in zip(CONV_LEAVES, gerrs))
                + f" of each one's largest (limit {CONV_GRAD_RTOL})")
            if not (err <= CONV_VALUE_RTOL and gerr <= CONV_GRAD_RTOL):
                raise AssertionError(f"conv {shape} {name}: error {err}, "
                                     f"gradients {gerr}")
            res[shape][name] = entry
    return res


def random_checkpoint(cfg, path: str, seed: int = 0) -> None:
    """Glorot-uniform weights, zero biases (an LSTM's forget bias 1), in
    the reference checkpoint's keypath format."""
    from ctc_asr_tpu_torch.models import init_shapes
    rng = np.random.default_rng(seed)
    flat = {}
    H = cfg.model.rnn_units
    for k, shape in init_shapes(cfg.model, cfg.features.feature_dim).items():
        if k.endswith("/b"):
            v = np.zeros(shape, np.float32)
            if k.startswith("rnn/") and cfg.model.rnn_type == "lstm":
                v[H:2 * H] = 1.0
        else:
            fan_in, fan_out = shape[-2], shape[-1]
            rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            lim = np.sqrt(6.0 / (fan_in * rf + fan_out * rf))
            v = rng.uniform(-lim, lim, shape).astype(np.float32)
        flat["params/" + k] = v
    flat["step"] = np.zeros((), np.int32)
    np.savez(path, **flat)


def run_cli(argv) -> str:
    from ctc_asr_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} returned {rc}")
    return out


def paths_agreement(tag: str, cfg, params, manifest: str,
                    limit: float = ARGMAX_AGREEMENT) -> None:
    """Every eval batch of ``manifest`` through the kernel path (K1 and
    K2, or K4 for a GRU model) and the plain path of ``cfg``'s model on
    the same weights. Raises unless the logits are finite, of the expected shape and lengths, and
    the per-frame argmax agrees on ``limit`` of the valid frames,
    pooled over the batches (random weights give logits of std ~0.05,
    so a few per mille of the frames have top-2 margins under 1e-3,
    where bf16 rounding decides the argmax)."""
    import torch
    from ctc_asr_tpu_torch.data import DataLoader, read_manifest
    from ctc_asr_tpu_torch.evaluate import make_eval_step
    from ctc_asr_tpu_torch.features import frame_lengths_from_sample_lengths
    from ctc_asr_tpu_torch.models import output_lengths
    from ctc_asr_tpu_torch.ops.greedy import greedy_decode
    plain_cfg = dataclasses.replace(
        cfg, features=dataclasses.replace(cfg.features, use_pallas=False),
        model=dataclasses.replace(cfg.model, use_pallas_rnn=False))
    kernel_step = make_eval_step(cfg, "cuda")
    plain_step = make_eval_step(plain_cfg, "cuda")
    loader = DataLoader(read_manifest(manifest), cfg.data, cfg.features,
                        drop_last=False)
    err, n_agree, n_frames, same, n_utts = 0.0, 0, 0, 0, 0
    for batch in loader.iter_epoch(0):
        lk, lens_k = kernel_step(params, batch.samples, batch.sample_lengths)
        lp, lens_p = plain_step(params, batch.samples, batch.sample_lengths)
        flens = frame_lengths_from_sample_lengths(
            torch.as_tensor(batch.sample_lengths), cfg.features)
        want_lens = output_lengths(flens, cfg.model).cuda()
        if lk.shape[0] != batch.samples.shape[0] \
                or lk.shape[2] != cfg.model.num_classes \
                or not torch.equal(lens_k, want_lens) \
                or not torch.equal(lens_k, lens_p):
            raise AssertionError(f"bad logits shape {tuple(lk.shape)} or "
                                 "lengths")
        if not torch.isfinite(lk).all():
            raise AssertionError("non-finite logits on the kernel path")
        valid = (torch.arange(lk.shape[1], device=lk.device)[None, :]
                 < lens_k[:, None])
        err = max(err, (lk - lp).abs()[valid].max().item())
        n_agree += int((lk.argmax(-1) == lp.argmax(-1))[valid].sum())
        n_frames += int(valid.sum())
        ids_k, dl_k = greedy_decode(lk, lens_k)
        ids_p, dl_p = greedy_decode(lp, lens_p)
        same += sum(int(torch.equal(ids_k[i, :dl_k[i]], ids_p[i, :dl_p[i]]))
                    for i in range(batch.valid))
        n_utts += batch.valid
    agree = n_agree / n_frames
    log(f"[{tag}] kernel vs plain path over {n_utts} utterances / "
        f"{n_frames} frames of {tuple(lk.shape[1:])} logits: max logit "
        f"err={err:.3e} argmax agreement={agree:.6f} (limit "
        f"{limit}) identical transcripts={same}/{n_utts}")
    if agree < limit:
        raise AssertionError(f"{tag}: argmax agreement {agree} < {limit}")


# the Conformer cell's buckets at T' 216 and 422 (libri_train_b64): the
# padded length and the range of its rows' encoder lengths
ATTENTION_CASES = ((216, 33, 213), (422, 389, 420))
# K9's output and gradients against the plain core in f32: the largest
# error over the largest magnitude (at least 0.01), two bf16 ulps
ATTENTION_TOL = 1.6e-2


def attention_inputs(B: int, H: int, T: int, lo: int, hi: int, seed: int):
    """q, the biases u, v [H, 64] (f32), k, v [B, H, T, 64] and p [H,
    2T-1, 64] bf16 in the projections' layouts, the output's gradient,
    and lengths drawn in [lo, hi] (int32, on the card)."""
    import torch
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(lo, hi + 1, size=B))[::-1].copy()
    g = torch.Generator("cuda").manual_seed(seed)

    def mk(*shape):
        return (0.5 * torch.randn(*shape, generator=g, device="cuda")).to(
            torch.bfloat16)
    q, k, v, do = (mk(B, T, H, 64).transpose(1, 2) for _ in range(4))
    u, vb = (mk(H, 64).float() for _ in range(2))
    p = mk(2 * T - 1, H, 64).transpose(0, 1)
    return [q, u, vb, k, v, p], do, torch.from_numpy(lens).to(
        "cuda", torch.int32)


def attention_err(got, want) -> float:
    """Largest error over the largest magnitude of ``want`` (at least
    0.01)."""
    return ((got.float() - want.float()).abs().max()
            / max(want.float().abs().max().item(), 1e-2)).item()


def phase_attention() -> dict:
    """K9 against the plain core (``rel_queries`` and
    ``attention_core_plain``) at the Conformer cell's shapes
    (``ATTENTION_CASES``): the errors of the output and the six input
    gradients (q, the biases u and v, k, v, p) against the plain core on
    the inputs in f32 (qu and qv rounded to bf16 as K9 rounds them),
    beside the plain core's own in bf16; two backward
    calls bit-equal; the CUDA-event medians of the forward (no grad) and
    the forward + backward of K9, of the plain core and of
    ``scaled_dot_product_attention`` with the relative term and the mask
    as an additive bias (its build included; a yardstick the port never
    calls), and K9's own device time from ``torch.profiler`` (the
    CUDA-event time of a call holds its host time where the host is
    slower); the bound of the same work for the rows' real lengths
    (``asrbench/reference/conformer.attention_work``, forward and
    backward; the forward alone its three products and its reads and
    writes); the peak memory of one layer's forward + backward above its
    inputs."""
    import torch
    import torch.nn.functional as F
    from asrbench.reference.conformer import attention_work
    from ctc_asr_tpu_torch.models import conformer
    from ctc_asr_tpu_torch.ops import attention_cuda as ac
    B, H = 64, 8
    names = ("o", "dq", "du", "dvb", "dk", "dv", "dp")
    out = {}
    for T, lo, hi in ATTENTION_CASES:
        xs, do, lens = attention_inputs(B, H, T, lo, hi, seed=T)
        key_pad = torch.arange(T, device="cuda")[None, :] >= lens[:, None]

        def fused(*ys):
            return conformer.attention_core(*ys, key_pad, lens)

        def plain(q, u, vb, k, v, p):
            return conformer.attention_core_plain(
                *conformer.rel_queries(q, u, vb), k, v, p, key_pad)

        def plain_f32(q, u, vb, k, v, p):
            qs = [x + (x.bfloat16().float() - x).detach()
                  for x in conformer.rel_queries(q, u, vb)]
            return conformer.attention_core_plain(*qs, k, v, p, key_pad)

        def library(q, u, vb, k, v, p):
            qu, qv = conformer.rel_queries(q, u, vb)
            bias = conformer.rel_shift(torch.matmul(qv, p.transpose(-2, -1)))
            bias = bias.masked_fill(key_pad[:, None, None, :],
                                    conformer.MASK_FILL)
            o = F.scaled_dot_product_attention(qu, k, v, attn_mask=bias,
                                               scale=1.0)
            return o.masked_fill(key_pad[:, None, :, None], 0.0)

        def leaves(ins):
            return [x.detach().clone().requires_grad_() for x in ins]

        def fwd_bwd(fn, ys):
            o = fn(*ys)
            return [o.detach(), *torch.autograd.grad(o, ys, do.to(o.dtype))]

        n0 = (ac.rel_attention.launches, ac.rel_attention_backward.launches)
        ys = leaves(xs)
        got, again = fwd_bwd(fused, ys), fwd_bwd(fused, ys)
        if (ac.rel_attention.launches - n0[0],
                ac.rel_attention_backward.launches - n0[1]) != (2, 2):
            raise AssertionError("K9 did not launch once a call")
        want = fwd_bwd(plain_f32, leaves([x.float() for x in xs]))
        pl = fwd_bwd(plain, leaves(xs))
        torch.cuda.synchronize()
        err = {n: attention_err(g_, w) for n, g_, w in zip(names, got, want)}
        plain_err = {n: attention_err(g_, w)
                     for n, g_, w in zip(names, pl, want)}
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("K9: two backward calls differ")
        if max(err.values()) > ATTENTION_TOL:
            raise AssertionError(f"K9 at T'={T}: errors {err} over "
                                 f"{ATTENTION_TOL}")
        row = {"B": B, "H": H, "T": T, "lengths": [lo, hi], "err": err,
               "plain_err": plain_err}
        cfg = {"model": {"d_model": H * 64, "n_layers": 1}}
        frames = lens.tolist()
        w = attention_work(cfg, frames)
        d, rows = H * 64, float(sum(frames))
        fwd_w = {"flops": 6.0 * d * sum(float(t) * t for t in frames),
                 # q, k, v read and o written; p's rows once
                 "bytes": 2.0 * d * (4 * rows + 2 * max(frames) - 1)}
        row["bound_ms"] = {"fwd": bound(fwd_w["bytes"], fwd_w["flops"],
                                        PEAK_BF16),
                           "fwd_bwd": bound(w["bytes"], w["flops"],
                                            PEAK_BF16)}
        for name, fn in (("kernel_ms", fused), ("plain_ms", plain),
                         ("library_ms", library)):
            ys = leaves(xs)

            def forward(fn=fn, ys=ys):
                with torch.no_grad():
                    fn(*ys)
            row[name] = {"fwd": cuda_ms(forward, reps=20),
                         "fwd_bwd": cuda_ms(lambda fn=fn, ys=ys:
                                            fwd_bwd(fn, ys), reps=10)}
            if fn is fused:     # one kernel forward, three backward
                row["device_ms"] = {
                    "fwd": _device_ms(forward, "rel_attn"),
                    "fwd_bwd": 4 * _device_ms(
                        lambda ys=ys: fwd_bwd(fused, ys), "rel_attn")}
        peak = {}
        for name, fn in (("kernel", fused), ("plain", plain)):
            ys = leaves(xs)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd(fn, ys)
            torch.cuda.synchronize()
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
        row["peak_mib"] = peak
        log(f"[attention] K9 B={B} H={H} T'={T} (rows {lo}-{hi}): fwd "
            f"{row['kernel_ms']['fwd']:.4f} ms, fwd+bwd "
            f"{row['kernel_ms']['fwd_bwd']:.4f} ms (device "
            f"{row['device_ms']['fwd']:.4f} / "
            f"{row['device_ms']['fwd_bwd']:.4f} ms); bound "
            f"{row['bound_ms']['fwd']['bound_ms']:.4f} / "
            f"{row['bound_ms']['fwd_bwd']['bound_ms']:.4f} ms "
            f"({row['bound_ms']['fwd_bwd']['bound_by']}); plain "
            f"{row['plain_ms']['fwd']:.4f} / {row['plain_ms']['fwd_bwd']:.4f}"
            f" ms; sdpa + bias {row['library_ms']['fwd']:.4f} / "
            f"{row['library_ms']['fwd_bwd']:.4f} ms; peak MiB above the "
            f"inputs {peak['kernel']:.1f} (plain {peak['plain']:.1f}); "
            f"errors {json.dumps({n: round(e, 6) for n, e in err.items()})}"
            f" (plain bf16 "
            f"{json.dumps({n: round(e, 6) for n, e in plain_err.items()})})")
        out[f"T{T}"] = row
    return out


def phase_slice(tmp: str) -> dict:
    from ctc_asr_tpu_torch.checkpoint import load_params
    from ctc_asr_tpu_torch.config import apply_overrides, preset
    from ctc_asr_tpu_torch.data import read_manifest
    from ctc_asr_tpu_torch.data.synth import generate_corpus
    from ctc_asr_tpu_torch.ops import lstm_cuda, stft_cuda

    t0 = time.perf_counter()
    manifest = generate_corpus(os.path.join(tmp, "synth"),
                               num_utterances=64, seed=0)
    ckpt = os.path.join(tmp, "step_00000000.npz")
    overrides = {"data.eval_manifest": manifest, "data.batch_size": "16",
                 "data.num_buckets": "1"}
    cfg = apply_overrides(preset("conv_bilstm3"), overrides)
    random_checkpoint(cfg, ckpt)
    log(f"[slice] corpus + checkpoint in {time.perf_counter() - t0:.1f} s")
    wavs = [u.path for u in read_manifest(manifest)][:2]

    stft_cuda.stft_features.launches = 0
    lstm_cuda.lstm_fwd.launches = 0
    ev = run_cli(["evaluate", "--preset", "conv_bilstm3", "--ckpt", ckpt,
                  "--device=cuda"]
                 + [f"--{k}={v}" for k, v in overrides.items()])
    tr = run_cli(["transcribe", "--preset", "conv_bilstm3", "--ckpt", ckpt,
                  "--device=cuda", *wavs])
    launches = {"stft": stft_cuda.stft_features.launches,
                "lstm": lstm_cuda.lstm_fwd.launches}
    log(f"[slice] kernel launches during evaluate+transcribe: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    res = json.loads(ev[ev.index("\n{") + 1:])
    log(f"[slice] evaluate: wer={res['wer']:.4f} (random weights) "
        f"rtf={res['rtf']:.6f} rtf_incl_compile="
        f"{res['rtf_incl_compile']:.6f} audio_s={res['audio_seconds']:.2f} "
        f"device={res['device']}")
    lines = [ln for ln in tr.splitlines() if "\t" in ln]
    if len(lines) != len(wavs):
        raise AssertionError(f"transcribe printed {len(lines)} results "
                             f"for {len(wavs)} wavs")

    paths_agreement("slice", cfg, load_params(ckpt, cfg, "cuda"), manifest)
    return {"launches": launches, "rtf": res["rtf"], "manifest": manifest}


def _train_counters():
    from ctc_asr_tpu_torch.ops import (ctc_cuda, gru_cuda, lstm_cuda,
                                       stft_cuda)
    c = {k: (fn, "launches") for k, fn in (
        ("stft", stft_cuda.stft_features), ("lstm_fwd", lstm_cuda.lstm_fwd),
        ("lstm_bwd", lstm_cuda.lstm_bwd), ("gru_fwd", gru_cuda.gru_fwd),
        ("gru_bwd", gru_cuda.gru_bwd), ("ctc_alpha", ctc_cuda.ctc_alpha),
        ("ctc_beta_grad", ctc_cuda.ctc_beta_grad))}
    return c


def _count_launches(run, expect_none=()):
    """Set every train-path counter to 0, call ``run()``, and return
    (its result, the counts). Raises if a kernel named in ``expect_none``
    launched, or if any other kernel did not."""
    counters = _train_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    out = run()
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    idle = [k for k in launches if k not in expect_none and launches[k] <= 0]
    stray = [k for k in expect_none if launches[k] > 0]
    if idle or stray:
        raise AssertionError(f"kernels of the path that never launched: "
                             f"{idle}; kernels off the path that did: "
                             f"{stray}; counts {launches}")
    return out, launches


_LSTM_KERNELS = ("lstm_fwd", "lstm_bwd")
_GRU_KERNELS = ("gru_fwd", "gru_bwd")


def _read_metrics(train_dir: str) -> dict:
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r for r in recs if "loss" in r}


def phase_train(tmp: str, manifest: str, rnn_type: str = "lstm") -> dict:
    """``cli train`` on the card at full ``conv_bilstm3`` width with the
    given cell: to a checkpoint at step 20, then resumed to step 40, then
    ``cli evaluate`` on the result. The other cell's kernels must not
    launch."""
    from ctc_asr_tpu_torch.config import apply_overrides, preset
    from ctc_asr_tpu_torch import checkpoint as ckpt_mod
    from ctc_asr_tpu_torch import train as train_mod
    tag = "train" if rnn_type == "lstm" else f"{rnn_type} train"
    train_dir = os.path.join(tmp, f"train_{rnn_type}")
    overrides = {"data.train_manifest": manifest,
                 "data.eval_manifest": manifest, "data.batch_size": "16",
                 "data.num_buckets": "1", "train.train_dir": train_dir,
                 "train.learning_rate": "3e-4", "train.log_every": "1",
                 "train.sync_every": "4", "train.checkpoint_every": "20",
                 "train.eval_every": "0", "train.total_steps": "40",
                 "model.rnn_type": rnn_type}
    cfg = apply_overrides(preset("conv_bilstm3"), overrides)
    # a random full-width train state, written in the reference's format
    state = train_mod.init_train_state(cfg, "cuda")
    ckpt_mod.save_checkpoint(train_dir + "/ckpt", 0,
                             train_mod.state_to_flat(cfg, state))
    args = ["train", "--preset", "conv_bilstm3", "--device=cuda"] \
        + [f"--{k}={v}" for k, v in overrides.items()]
    times = {}

    def run():
        t0 = time.perf_counter()
        run_cli(args + ["--max-steps=20"])
        times["half"] = time.perf_counter() - t0
        out = run_cli(args)
        times["wall"] = time.perf_counter() - t0
        return out

    out, launches = _count_launches(
        run, _GRU_KERNELS if rnn_type == "lstm" else _LSTM_KERNELS)
    log(f"[{tag}] kernel launches during cli train (40 steps): {launches}")
    if "resumed from step 20" not in out:
        raise AssertionError("the second cli train did not resume at 20")
    recs = _read_metrics(train_dir)
    if sorted(recs) != list(range(1, 41)):
        raise AssertionError(f"metrics for steps {sorted(recs)}")
    loss = [recs[k]["loss"] for k in range(1, 41)]
    gn = [recs[k]["grad_norm"] for k in range(1, 41)]
    first, last = np.mean(loss[:5]), np.mean(loss[-5:])
    step_s = float(np.median([recs[k]["step_time_s"] for k in range(25, 41)]))
    log(f"[{tag}] loss steps 1-5 mean {first:.4f}, 36-40 mean {last:.4f}; "
        f"grad_norm {min(gn):.4f}..{max(gn):.4f}; wall {times['wall']:.1f} s "
        f"(first 20 steps incl. first calls {times['half']:.1f} s); step "
        f"time {step_s:.4f} s (median, steps 25-40)")
    if not (np.all(np.isfinite(loss)) and np.all(np.isfinite(gn))
            and last < first):
        raise AssertionError(f"loss {loss} grad_norm {gn}")
    ev = run_cli(["evaluate", "--preset", "conv_bilstm3", "--ckpt",
                  train_dir, "--device=cuda"]
                 + [f"--{k}={v}" for k, v in overrides.items()])
    res = _eval_json(ev)
    log(f"[{tag}] evaluate on the step-40 checkpoint: wer={res['wer']:.4f} "
        f"cer={res['cer']:.4f} over {res['utterances']} utterances")
    return {"launches": launches, "loss_first": first, "loss_last": last,
            "train_dir": train_dir, "wer": res["wer"], "cfg": cfg,
            "step_s": step_s}


def phase_gru_slice(tmp: str, manifest: str) -> dict:
    """The GRU family end to end on the card: training with resume and
    evaluation (``phase_train``), ``cli transcribe``, the kernel path
    against the plain path on the random and the trained weights, and a
    short run of the vanilla cell."""
    from ctc_asr_tpu_torch.checkpoint import load_params
    from ctc_asr_tpu_torch.data import read_manifest
    from ctc_asr_tpu_torch.ops import gru_cuda
    tr = phase_train(tmp, manifest, "gru")
    cfg, train_dir = tr["cfg"], tr["train_dir"]
    wavs = [u.path for u in read_manifest(manifest)][:2]
    n0 = gru_cuda.gru_fwd.launches
    out = run_cli(["transcribe", "--preset", "conv_bilstm3",
                   "--model.rnn_type=gru", "--ckpt", train_dir,
                   "--device=cuda", *wavs])
    if len([ln for ln in out.splitlines() if "\t" in ln]) != len(wavs) \
            or gru_cuda.gru_fwd.launches <= n0:
        raise AssertionError("cli transcribe on the GRU checkpoint failed")
    paths_agreement("gru slice, random weights", cfg, load_params(
        os.path.join(train_dir, "ckpt", "step_00000000.npz"), cfg, "cuda"),
        manifest, limit=ARGMAX_AGREEMENT_RANDOM_GRU)
    paths_agreement("gru slice, step 40", cfg,
                    load_params(train_dir, cfg, "cuda"), manifest)

    # the vanilla tanh cell: plain recurrence on the card, no kernel
    rnn_dir = os.path.join(tmp, "train_rnn")
    _, launches = _count_launches(lambda: run_cli(
        ["train", "--preset", "conv_bilstm3", "--device=cuda",
         "--model.rnn_type=rnn", "--model.rnn_layers=1",
         f"--data.train_manifest={manifest}", "--data.batch_size=16",
         "--data.num_buckets=1", f"--train.train_dir={rnn_dir}",
         "--train.learning_rate=3e-4", "--train.log_every=1",
         "--max-steps=5"]), _LSTM_KERNELS + _GRU_KERNELS)
    loss = [r["loss"] for r in _read_metrics(rnn_dir).values()]
    log(f"[rnn train] vanilla cell, 1 layer of Bi-RNN-512, 5 steps at B=16: "
        f"loss {loss[0]:.4f} -> {loss[-1]:.4f}; launches {launches}")
    if len(loss) != 5 or not np.all(np.isfinite(loss)):
        raise AssertionError(f"vanilla cell: loss {loss}")
    return tr


def phase_datatools(tmp: str, manifest: str, gru: dict) -> dict:
    """``compute-stats``, ``prepare-features`` (f16 and int8), then ``cli
    train`` and ``cli evaluate`` of the GRU model from the cache, and a
    traced run with ``train.profile_dir``."""
    cfg, train_dir = gru["cfg"], gru["train_dir"]
    common = ["--preset", "conv_bilstm3", "--device=cuda"]
    data = ["--data.batch_size=16", "--data.num_buckets=1"]
    stats = os.path.join(tmp, "stats.npz")
    t0 = time.perf_counter()
    run_cli(["compute-stats", *common, *data, "--manifest", manifest,
             "--out", stats])
    with np.load(stats) as z:
        frames, mean, var = float(z["frames"]), z["mean"], z["var"]
    if not (frames > 0 and mean.shape == (cfg.features.feature_dim,)
            and np.all(np.isfinite(mean)) and np.all(var > 0)):
        raise AssertionError(f"compute-stats: frames {frames}")
    caches = {}
    for dtype in ("float16", "int8"):
        caches[dtype] = os.path.join(tmp, f"cache_{dtype}")
        run_cli(["prepare-features", *common, *data, "--manifest", manifest,
                 "--out", caches[dtype], "--dtype", dtype])
    log(f"[datatools] compute-stats over {int(frames)} frames and two "
        f"caches in {time.perf_counter() - t0:.1f} s")

    gru_flags = ["--model.rnn_type=gru", f"--data.eval_manifest={manifest}",
                 *data]
    cached_dir = os.path.join(tmp, "train_gru_cached")
    prof_dir = os.path.join(tmp, "profile")
    off_path = ("stft",) + _LSTM_KERNELS

    def train_and_evaluate():
        run_cli(["train", *common, *gru_flags,
                 f"--data.train_manifest={manifest}",
                 f"--data.feature_cache={caches['float16']}",
                 f"--train.train_dir={cached_dir}",
                 f"--train.profile_dir={prof_dir}",
                 "--train.learning_rate=3e-4", "--train.log_every=1",
                 "--max-steps=6"])
        return {dtype: _eval_json(run_cli(
            ["evaluate", *common, *gru_flags, "--ckpt", train_dir,
             f"--data.feature_cache={path}"]))
            for dtype, path in caches.items()}

    ev, launches = _count_launches(train_and_evaluate, off_path)
    loss = [r["loss"] for r in _read_metrics(cached_dir).values()]
    traces = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, traces[0])) as f:
        trace = f.read()
    log(f"[datatools] cli train (6 steps) + evaluate from the caches: "
        f"launches {launches}; loss {loss[0]:.4f} -> {loss[-1]:.4f}; trace "
        f"{traces[0]} of {len(trace) / 1e6:.1f} MB")
    if len(loss) != 6 or not np.all(np.isfinite(loss)):
        raise AssertionError(f"training from the cache: loss {loss}")
    if len(traces) != 1 or "gru_fwd_persistent_kernel" not in trace \
            or "gru_bwd_persistent_kernel" not in trace:
        raise AssertionError("train.profile_dir: no trace of the GRU kernels")
    d16 = abs(ev["float16"]["wer"] - gru["wer"])
    log(f"[datatools] step-40 GRU checkpoint: WER from wavs "
        f"{gru['wer']:.4f}, from the f16 cache {ev['float16']['wer']:.4f} "
        f"(difference {d16:.4f}, limit {CACHE_WER_TOL}), from the int8 "
        f"cache {ev['int8']['wer']:.4f}; rtf f16 "
        f"{ev['float16']['rtf']:.6f} int8 {ev['int8']['rtf']:.6f}")
    if d16 > CACHE_WER_TOL or not np.isfinite(ev["int8"]["wer"]):
        raise AssertionError(f"WER from the cache: {ev}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 9: data parallelism across processes
# ---------------------------------------------------------------------------

DP_TIMEOUT_S = 600      # the two ranks' whole run; a hang fails the phase
DP_HALF, DP_STEPS = 20, 40


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _params_digest(params: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn`` followed by a synchronize (a gloo
    collective blocks the host, so a CUDA event would time its wait)."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _dp_world_one(smi: str) -> dict:
    """(a) NCCL at world size 1, the group formed here: the LSTM step at
    B=128 x 8 s through the DP step against the single-process step (and
    the single-process step against itself, the control) from one state:
    loss, gradient norm and every parameter after the update, bit for
    bit (the default step is deterministic: ``phase_repro``); then the
    all-reduce's device time on the gradients' flat buffer."""
    import torch
    import torch.distributed as dist
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.config import preset
    from ctc_asr_tpu_torch.parallel.dist import TIMEOUT, all_reduce_mean
    cfg = preset("conv_bilstm3")
    arrs = _step_batch()
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0, timeout=TIMEOUT)
    try:
        runs = {}
        for name, group in (("single", None), ("single again", None),
                            ("dp", dist.group.WORLD)):
            st = train_mod.init_train_state(cfg, "cuda")
            m = train_mod.make_step_fn(cfg, group)(st, *arrs)
            runs[name] = (m["loss"].cpu(), m["grad_norm"].cpu(),
                          {k: v.detach().clone()
                           for k, v in st["params"].items()})
        leaves = [torch.zeros_like(p) for p in runs["dp"][2].values()]
        leaves.append(torch.zeros((), device="cuda"))
        n = sum(t.numel() for t in leaves)
        mean_ms = cuda_ms(lambda: all_reduce_mean(leaves, dist.group.WORLD),
                          reps=20)
        flat = torch.zeros(n, device="cuda")
        bare_ms = cuda_ms(lambda: dist.all_reduce(flat), reps=20)
    finally:
        dist.destroy_process_group()

    def same(a, b):
        return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))
    control, equal = same(*map(runs.get, ("single", "single again"))), \
        same(*map(runs.get, ("single", "dp")))
    log(f"[dp nccl] world 1, B=128 x 8 s LSTM step: loss "
        f"{runs['dp'][0].item():.6f} grad_norm {runs['dp'][1].item():.6f}; "
        f"DP step bit-equal to the single-process step: {equal} (the "
        f"single-process step against itself: {control})")
    log(f"[dp nccl] all-reduce of the flat buffer ({n} f32: every gradient "
        f"and the loss), CUDA events, median of 20: all_reduce_mean (cat, "
        f"all_reduce, divide) {mean_ms:.4f} ms, the bare all_reduce "
        f"{bare_ms:.4f} ms; {smi}")
    if not equal:
        raise AssertionError("the NCCL world-1 DP step differs from the "
                             "single-process step")
    return {"allreduce_ms": mean_ms, "bare_allreduce_ms": bare_ms,
            "numel": n}


def _dp_overrides(manifest: str, train_dir: str) -> dict:
    return {"data.train_manifest": manifest, "data.eval_manifest": manifest,
            "data.batch_size": "16", "data.num_buckets": "1",
            "train.train_dir": train_dir, "train.learning_rate": "3e-4",
            "train.log_every": "1", "train.sync_every": "4",
            "train.checkpoint_every": str(DP_HALF), "train.eval_every": "0",
            "train.total_steps": str(DP_STEPS), "model.dropout": "0"}


def dp_worker(argv) -> int:
    """One rank of (b): ``chip_smoke.py --dp-worker RANK PORT TRAIN_DIR
    MANIFEST BUILD_DIR OUT``. Builds the kernels into BUILD_DIR (both
    ranks start cold, together), joins a gloo group of two on the one
    card, runs ``cli train`` to step 20 and resumed to 40 and ``cli
    evaluate`` greedy and beam, counting the kernels' launches, and
    writes its parameters' digest and counts to OUT."""
    import torch
    import torch.distributed as dist
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.ops import beam_cuda, build, lstm_cuda, stft_cuda
    from ctc_asr_tpu_torch.parallel.dist import TIMEOUT, all_reduce_mean
    rank, port = int(argv[0]), int(argv[1])
    train_dir, manifest, build_dir, out_path = argv[2:6]
    tag = f"[dp rank {rank}]"
    build.BUILD_ROOT = build_dir
    t0 = time.perf_counter()
    build.load()
    log(f"{tag} kernels ready in {time.perf_counter() - t0:.2f} s (cached="
        f"{build.build_info.get('cached')})")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank, timeout=TIMEOUT)
    overrides = [f"--{k}={v}"
                 for k, v in _dp_overrides(manifest, train_dir).items()]
    args = ["train", "--preset", "conv_bilstm3", "--device=cuda", *overrides]
    states = []
    real_train = train_mod.train

    def keep_state(*a, **k):
        states.append(real_train(*a, **k))
        return states[-1]

    def run():
        t = time.perf_counter()
        out = run_cli(args + [f"--max-steps={DP_HALF}"]) + run_cli(args)
        return out, time.perf_counter() - t

    try:
        train_mod.train = keep_state
        try:
            (out, wall), launches = _count_launches(run, _GRU_KERNELS)
        finally:
            train_mod.train = real_train
        if f"resumed from step {DP_HALF}" not in out:
            raise AssertionError(f"{tag} did not resume at step {DP_HALF}")
        params = states[-1]["params"]
        leaves = [torch.zeros_like(p) for p in params.values()]
        leaves.append(torch.zeros((), device="cuda"))
        ar_ms = _host_ms(lambda: all_reduce_mean(leaves, dist.group.WORLD),
                         reps=5)
        log(f"{tag} cli train (40 steps, resumed at 20) in {wall:.1f} s; "
            f"launches {launches}; gloo all_reduce_mean of the gradients "
            f"(host-staged) {ar_ms:.2f} ms")
        evals = {}
        counters = {"stft": stft_cuda.stft_features,
                    "lstm_fwd": lstm_cuda.lstm_fwd,
                    "beam": beam_cuda.beam_search_decode_cuda}
        for mode in ("greedy", "beam"):
            for fn in counters.values():
                fn.launches = 0
            res = _eval_json(run_cli(
                ["evaluate", "--preset", "conv_bilstm3", "--ckpt", train_dir,
                 "--device=cuda", f"--decode.method={mode}", *overrides]))
            evals[mode] = {"launches": {k: fn.launches
                                        for k, fn in counters.items()},
                           "utterances": res["utterances"],
                           "wer": res["wer"]}
            log(f"{tag} cli evaluate {mode}: {evals[mode]}")
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "digest": _params_digest(params),
                   "allreduce_ms": ar_ms, "evals": evals}, f)
    return 0


def _run_workers(flag: str, argvs: list, timeout: int, prefix: str) -> list:
    """Start this script once a rank (``flag`` and its arguments), wait
    for all within ``timeout``, kill them all if one hangs, echo their
    ``prefix`` lines; raises if one failed."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, *a],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in argvs]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, texts)):
        for line in text.splitlines():
            if line.startswith((prefix, "[train] resumed")):
                log(line if line.startswith(prefix)
                    else f"{prefix} rank {r}] " + line)
        if p.returncode != 0:
            raise RuntimeError(f"{flag} rank {r} exited {p.returncode}:\n"
                               f"{text[-6000:]}")
    return texts


def phase_dp(tmp: str, manifest: str, one_proc_step_s: float,
             smi: str) -> dict:
    """Data parallelism on the one card: (a) the NCCL world-1 step; (b)
    two processes sharing the card in a gloo group (NCCL puts no two
    ranks on one GPU), full-width ``conv_bilstm3`` at B=16 a rank,
    dropout 0: ``cli train`` 20 steps to a checkpoint and resumed to 40,
    then ``cli evaluate`` greedy and beam, each rank a worker process of
    this script. K1, K2, K3, K6 and K7 must launch on each rank (K8 in
    the beam evaluation), the ranks' parameters must be bit-equal, step
    1 must agree with one process at B=32 on the same global batch, the
    loss must fall, and the evaluations must count the whole corpus."""
    import torch
    from ctc_asr_tpu_torch import checkpoint as ckpt_mod
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.config import apply_overrides, preset
    from ctc_asr_tpu_torch.data import DataLoader, read_manifest
    world_one = _dp_world_one(smi)
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    log(f"[dp] compute mode: {mode.strip()}")
    train_dir = os.path.join(tmp, "train_dp")
    cfg = apply_overrides(preset("conv_bilstm3"),
                          _dp_overrides(manifest, train_dir))
    state = train_mod.init_train_state(cfg, "cuda")
    ckpt_mod.save_checkpoint(train_dir + "/ckpt", 0,
                             train_mod.state_to_flat(cfg, state))
    # one process at B=32 on the two ranks' first batches, same state
    firsts = [next(DataLoader(read_manifest(manifest), cfg.data,
                              cfg.features, shard_idx=r,
                              num_shards=2).iter_epoch(0)) for r in range(2)]
    arrs = [torch.from_numpy(np.concatenate([getattr(b, f) for b in firsts]))
            .cuda() for f in ("samples", "sample_lengths", "labels",
                              "label_lengths")]
    ref = train_mod.make_step_fn(cfg)(state, *arrs)
    ref = {k: float(ref[k]) for k in ("loss", "grad_norm")}
    corpus = len(DataLoader(read_manifest(manifest), cfg.data, cfg.features,
                            drop_last=False).global_manifest)
    del state, arrs
    torch.cuda.empty_cache()

    port = _free_port()
    outs = [os.path.join(tmp, f"dp_rank{r}.json") for r in range(2)]
    build_dir = os.path.join(tmp, "build_dp")
    t0 = time.perf_counter()
    _run_workers("--dp-worker", [
        [str(r), str(port), train_dir, manifest, build_dir, outs[r]]
        for r in range(2)], DP_TIMEOUT_S, "[dp")
    wall = time.perf_counter() - t0
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    recs = _read_metrics(train_dir)
    if sorted(recs) != list(range(1, DP_STEPS + 1)):
        raise AssertionError(f"metrics for steps {sorted(recs)}")
    loss = [recs[k]["loss"] for k in range(1, DP_STEPS + 1)]
    first, last = np.mean(loss[:5]), np.mean(loss[-5:])
    loss_err = abs(recs[1]["loss"] / ref["loss"] - 1)
    gn_err = abs(recs[1]["grad_norm"] / ref["grad_norm"] - 1)
    step_s = float(np.median([recs[k]["step_time_s"]
                              for k in range(25, DP_STEPS + 1)]))
    log(f"[dp] two ranks, gloo, one card: {wall:.1f} s for both workers; "
        f"step 1 loss {recs[1]['loss']:.6f} against one process at B=32 "
        f"{ref['loss']:.6f} (rel err {loss_err:.3e}, limit "
        f"{STEP_LOSS_RTOL}); grad_norm {recs[1]['grad_norm']:.6f} against "
        f"{ref['grad_norm']:.6f} (rel err {gn_err:.3e}, limit "
        f"{STEP_GNORM_RTOL}); loss steps 1-5 mean {first:.4f}, 36-40 mean "
        f"{last:.4f}; ranks' parameters bit-equal: "
        f"{res[0]['digest'] == res[1]['digest']}")
    log(f"[dp] step ms (host clock, median of steps 25-40, B=16 a rank): two "
        f"ranks in a gloo group {step_s * 1e3:.2f}, one process (the train "
        f"phase) {one_proc_step_s * 1e3:.2f}; gloo all-reduce of the "
        f"gradients (host-staged) {res[0]['allreduce_ms']:.2f}, "
        f"{res[1]['allreduce_ms']:.2f} ms; NCCL at world 1 "
        f"{world_one['allreduce_ms']:.4f} ms; {smi}")
    bad = []
    if res[0]["digest"] != res[1]["digest"]:
        bad.append("the ranks' parameters differ")
    if not (loss_err <= STEP_LOSS_RTOL and gn_err <= STEP_GNORM_RTOL):
        bad.append(f"step 1 against one process: loss {loss_err}, "
                   f"grad_norm {gn_err}")
    if not (np.all(np.isfinite(loss)) and last < first):
        bad.append(f"loss {loss}")
    for r, x in enumerate(res):
        for m, e in x["evals"].items():
            if e["utterances"] != corpus:
                bad.append(f"rank {r} {m}: {e['utterances']} utterances of "
                           f"{corpus}")
            idle = [k for k, n in e["launches"].items()
                    if (n > 0) != (k != "beam" or m == "beam")]
            if idle:
                bad.append(f"rank {r} {m}: launches {e['launches']}")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"world_one": world_one, "step_ms": step_s * 1e3,
            "launches": [x["launches"] for x in res]}


# ---------------------------------------------------------------------------
# phase 10: tensor parallelism and the row-sharded LM lookup
# ---------------------------------------------------------------------------

TP_TIMEOUT_S = 600      # the two ranks' whole run; a hang fails the phase
TP_HALF, TP_STEPS = 10, 20
TP_DECODE_B, TP_DECODE_T = 16, 175


def _tp_overrides(manifest: str, train_dir: str) -> dict:
    return {"data.train_manifest": manifest, "data.eval_manifest": manifest,
            "data.batch_size": "16", "data.num_buckets": "1",
            "train.train_dir": train_dir, "train.learning_rate": "3e-4",
            "train.log_every": "1", "train.sync_every": "4",
            "train.checkpoint_every": str(TP_HALF), "train.eval_every": "0",
            "train.total_steps": str(TP_STEPS), "model.dropout": "0",
            "mesh.model_axis": "2", "mesh.shard_model": "true"}


def _tp_decode_case():
    """The sharded-LM decode's input: seeded logits at B=16 x 175 frames
    and ragged lengths, on the card."""
    import torch
    logits = _beam_logits(TP_DECODE_B, TP_DECODE_T, seed=31)
    lens = torch.as_tensor(np.random.default_rng(32).integers(
        TP_DECODE_T // 2, TP_DECODE_T + 1, TP_DECODE_B), dtype=torch.int32)
    lens[0] = TP_DECODE_T
    return logits, lens.cuda()


def tp_worker(argv) -> int:
    """One rank of phase 10: ``chip_smoke.py --tp-worker RANK PORT
    TRAIN_DIR MANIFEST BUILD_DIR LM OUT``. Builds the kernels into
    BUILD_DIR, joins a gloo group of two on the one card, runs ``cli
    train --mesh.model_axis=2 --mesh.shard_model=true`` to step 10 and
    resumed to 20 (K1, K6 and K7 must launch, K2 to K5 must not), times
    a step's gather, then decodes B=16 x 175 frames with the row-sharded
    char LM of LM at ``lm_fusion_960h``'s beam, and writes its replicated
    leaves' digest, counts, ids and times to OUT."""
    import torch
    import torch.distributed as dist
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.config import apply_overrides, preset
    from ctc_asr_tpu_torch.ops import build
    from ctc_asr_tpu_torch.ops import lm as lm_mod
    from ctc_asr_tpu_torch.parallel.decode_dist import (
        make_sharded_lm_beam_decoder)
    from ctc_asr_tpu_torch.parallel.dist import (TIMEOUT, gather_columns,
                                                 grid_groups)
    from ctc_asr_tpu_torch.parallel.mesh import build_mesh
    from ctc_asr_tpu_torch.parallel.tp import sharded_keys
    rank, port = int(argv[0]), int(argv[1])
    train_dir, manifest, build_dir, lm_path, out_path = argv[2:7]
    tag = f"[tp rank {rank}]"
    build.BUILD_ROOT = build_dir
    build.load()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank, timeout=TIMEOUT)
    overrides = _tp_overrides(manifest, train_dir)
    args = ["train", "--preset", "conv_bilstm3", "--device=cuda",
            *[f"--{k}={v}" for k, v in overrides.items()]]
    states = []
    real_train = train_mod.train

    def keep_state(*a, **k):
        states.append(real_train(*a, **k))
        return states[-1]

    def run():
        t = time.perf_counter()
        out = run_cli(args + [f"--max-steps={TP_HALF}"]) + run_cli(args)
        return out, time.perf_counter() - t

    try:
        train_mod.train = keep_state
        try:
            (out, wall), launches = _count_launches(
                run, _LSTM_KERNELS + _GRU_KERNELS)
        finally:
            train_mod.train = real_train
        if f"resumed from step {TP_HALF}" not in out:
            raise AssertionError(f"{tag} did not resume at step {TP_HALF}")
        cfg = apply_overrides(preset("conv_bilstm3"), overrides)
        mesh = build_mesh(cfg.mesh)
        groups = grid_groups(mesh)
        sharded = sharded_keys(cfg, mesh)
        params = states[-1]["params"]
        rep = {k: v for k, v in params.items() if k not in sharded}
        shapes = {k: list(v.shape) for k, v in params.items()
                  if k in sharded}
        H = cfg.model.rnn_units
        hp = torch.randn((2, 16, 4 * H // 2), device="cuda")
        gather_ms = _host_ms(lambda: gather_columns(hp, groups.model), 20)
        log(f"{tag} cli train (20 steps, resumed at 10) in {wall:.1f} s; "
            f"launches {launches}; gather of a step's gates [2, 16, "
            f"{4 * H // 2}] f32 over gloo (host-staged) {gather_ms:.3f} ms")
        lm = lm_mod.load_lm(lm_path)
        dcfg = preset("lm_fusion_960h")
        decode, place = make_sharded_lm_beam_decoder(dcfg, groups.model, lm)
        table = place(torch.device("cuda"))
        logits, lens = _tp_decode_case()
        ids, out_lens = decode(logits, lens, table)
        decode_ms = _host_ms(lambda: decode(logits, lens, table), 3)
        log(f"{tag} sharded-LM decode, B={TP_DECODE_B} x {TP_DECODE_T}, "
            f"beam {dcfg.decode.beam_width}, table rows {table.shape[0]} of "
            f"{lm['table'].shape[0]}: {decode_ms:.1f} ms a batch")
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "digest": _params_digest(rep),
                   "shapes": shapes, "gather_ms": gather_ms,
                   "decode_ms": decode_ms, "ids": ids.cpu().tolist(),
                   "lens": out_lens.cpu().tolist()}, f)
    return 0


def phase_tp(tmp: str, manifest: str, smi: str) -> dict:
    """Tensor parallelism on the one card: two processes in a gloo group
    (NCCL puts no two ranks on one GPU), ``--mesh.model_axis=2
    --mesh.shard_model=true``, full-width ``conv_bilstm3`` at B=16,
    dropout 0, each rank a worker process of this script: ``cli train``
    10 steps to a checkpoint and resumed to 20, then the row-sharded
    char-LM decode. Step 1 must agree with one process on the same batch
    (the same plain recurrence), the replicated leaves must be bit-equal
    across the ranks, the loss must fall, K1, K6 and K7 must launch on
    each rank and K2 to K5 must not; the decode's ids must equal the
    replicated-table plain decoder's; ``cli evaluate`` in one process
    must read the TP checkpoint."""
    import torch
    from ctc_asr_tpu_torch import checkpoint as ckpt_mod
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.config import apply_overrides, preset
    from ctc_asr_tpu_torch.data import DataLoader, read_manifest
    from ctc_asr_tpu_torch.ops import lm as lm_mod
    from ctc_asr_tpu_torch.ops.beam import beam_search_decode
    from ctc_asr_tpu_torch.parallel.tp import hybrid_config
    train_dir = os.path.join(tmp, "train_tp")
    overrides = _tp_overrides(manifest, train_dir)
    cfg = apply_overrides(preset("conv_bilstm3"), overrides)
    state = train_mod.init_train_state(cfg, "cuda")
    ckpt_mod.save_checkpoint(train_dir + "/ckpt", 0,
                             train_mod.state_to_flat(cfg, state))
    # one process on the model group's first batch, same state, same
    # (plain) recurrence
    first = next(DataLoader(read_manifest(manifest), cfg.data,
                            cfg.features).iter_epoch(0))
    arrs = [torch.from_numpy(np.ascontiguousarray(getattr(first, f))).cuda()
            for f in ("samples", "sample_lengths", "labels",
                      "label_lengths")]
    one = {}
    for name, c in (("plain", hybrid_config(cfg)), ("kernel", cfg)):
        st = train_mod.init_train_state(c, "cuda")
        with torch.no_grad():
            for k, v in state["params"].items():
                st["params"][k].copy_(v)
        step = train_mod.make_step_fn(c)
        m = step(st, *arrs)
        one[name] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        one[name]["ms"] = _host_ms(lambda: step(st, *arrs), 3)
    corpus = len(DataLoader(read_manifest(manifest), cfg.data, cfg.features,
                            drop_last=False).global_manifest)
    lm_path = os.path.join(tmp, "tp_char_lm.npz")
    lm_mod.save_lm(lm_path, lm_mod.train_char_lm(
        [u.transcript for u in read_manifest(manifest)], order=4))
    del state, arrs
    torch.cuda.empty_cache()

    port = _free_port()
    outs = [os.path.join(tmp, f"tp_rank{r}.json") for r in range(2)]
    build_dir = os.path.join(tmp, "build_tp")
    t0 = time.perf_counter()
    _run_workers("--tp-worker", [
        [str(r), str(port), train_dir, manifest, build_dir, lm_path, outs[r]]
        for r in range(2)], TP_TIMEOUT_S, "[tp")
    wall = time.perf_counter() - t0
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    recs = _read_metrics(train_dir)
    if sorted(recs) != list(range(1, TP_STEPS + 1)):
        raise AssertionError(f"metrics for steps {sorted(recs)}")
    loss = [recs[k]["loss"] for k in range(1, TP_STEPS + 1)]
    head, tail = np.mean(loss[:5]), np.mean(loss[-5:])
    ref = one["plain"]
    loss_err = abs(recs[1]["loss"] / ref["loss"] - 1)
    gn_err = abs(recs[1]["grad_norm"] / ref["grad_norm"] - 1)
    step_s = float(np.median([recs[k]["step_time_s"]
                              for k in range(TP_HALF + 3, TP_STEPS + 1)]))
    # the replicated-table plain decoder on the same logits
    dcfg = preset("lm_fusion_960h").decode
    lm = lm_mod.load_lm(lm_path)
    logits, lens = _tp_decode_case()

    def replicated():
        return beam_search_decode(
            logits, lens, beam_width=dcfg.beam_width, lm_table=lm["table"],
            lm_weight=dcfg.lm_weight, word_bonus=dcfg.word_bonus,
            init_ctx=lm_mod.initial_context(int(lm["order"])),
            lm_vocab=lm_mod.V)

    want_ids, want_lens = replicated()
    rep_ms = _host_ms(replicated, 3)
    ids_equal = all(r["ids"] == want_ids.cpu().tolist()
                    and r["lens"] == want_lens.cpu().tolist() for r in res)
    ev = _eval_json(run_cli(["evaluate", "--preset", "conv_bilstm3",
                             "--ckpt", train_dir, "--device=cuda",
                             f"--data.eval_manifest={manifest}",
                             "--data.batch_size=16",
                             "--data.num_buckets=1"]))
    log(f"[tp] two ranks, model axis 2, gloo, one card: {wall:.1f} s for "
        f"both workers; sharded leaves {res[0]['shapes']['rnn/0/fwd/wh']} "
        f"of rnn/0/fwd/wh a rank; step 1 loss {recs[1]['loss']:.6f} against "
        f"one process (plain recurrence) {ref['loss']:.6f} (rel err "
        f"{loss_err:.3e}, limit {STEP_LOSS_RTOL}); grad_norm "
        f"{recs[1]['grad_norm']:.6f} against {ref['grad_norm']:.6f} (rel err "
        f"{gn_err:.3e}, limit {STEP_GNORM_RTOL}); loss steps 1-5 mean "
        f"{head:.4f}, 16-20 mean {tail:.4f}; replicated leaves bit-equal "
        f"across the ranks: {res[0]['digest'] == res[1]['digest']}")
    log(f"[tp] step ms at B=16 (host clock): two ranks, model axis 2 "
        f"{step_s * 1e3:.2f} (median of steps {TP_HALF + 3}-{TP_STEPS}); one "
        f"process, plain recurrence {one['plain']['ms']:.2f}, kernel path "
        f"{one['kernel']['ms']:.2f} (median of 3); a step's gate gather "
        f"{res[0]['gather_ms']:.3f}, {res[1]['gather_ms']:.3f} ms (x "
        f"{3 * TP_DECODE_T} a forward); {smi}")
    log(f"[tp decode] row-sharded char LM (order {int(lm['order'])}, "
        f"{lm['table'].shape[0]} rows, half a rank), B={TP_DECODE_B} x "
        f"{TP_DECODE_T}, beam {dcfg.beam_width}: ids equal to the "
        f"replicated-table plain decoder's: {ids_equal}; ms a batch (host "
        f"clock, median of 3): sharded {res[0]['decode_ms']:.1f}, "
        f"{res[1]['decode_ms']:.1f}, replicated (one process) {rep_ms:.1f}; "
        f"{smi}")
    log(f"[tp] cli evaluate, one process, on the TP checkpoint: wer="
        f"{ev['wer']:.4f} over {ev['utterances']} utterances")
    bad = []
    if res[0]["digest"] != res[1]["digest"]:
        bad.append("the ranks' replicated leaves differ")
    if not (loss_err <= STEP_LOSS_RTOL and gn_err <= STEP_GNORM_RTOL):
        bad.append(f"step 1 against one process: loss {loss_err}, "
                   f"grad_norm {gn_err}")
    if not (np.all(np.isfinite(loss)) and tail < head):
        bad.append(f"loss {loss}")
    if not ids_equal:
        bad.append("sharded-LM ids differ from the replicated decoder's")
    if ev["utterances"] != corpus or not np.isfinite(ev["wer"]):
        bad.append(f"cli evaluate on the TP checkpoint: {ev}")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"launches": [x["launches"] for x in res], "step_ms": step_s * 1e3,
            "one_ms": one, "gather_ms": res[0]["gather_ms"],
            "decode_ms": res[0]["decode_ms"], "replicated_ms": rep_ms}


# ---------------------------------------------------------------------------
# phase 11: sequence parallelism
# ---------------------------------------------------------------------------

SP_B, SP_S, SP_U = 16, 56320, 48


def phase_sp(smi: str) -> dict:
    """Sequence parallelism in one process over ``["cuda:0", "cuda:0"]``
    (one card, two time chunks), full-width ``conv_bilstm3`` at f32
    compute with the plain recurrence, B=16 x 56320 samples: K1 on one
    extended chunk against its plain version; the SP step's loss,
    gradient norm and per-leaf gradient cosines against the unsharded
    step; the SP eval step's argmax against the unsharded one; K1, K6
    and K7 launching in three SP train steps (K2 to K5 not); the step
    times of both."""
    import torch
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.config import preset
    from ctc_asr_tpu_torch.evaluate import make_eval_step
    from ctc_asr_tpu_torch.ops import stft_cuda
    from ctc_asr_tpu_torch.ops.ctc_cuda import ctc_loss
    from ctc_asr_tpu_torch.optim import global_norm
    from ctc_asr_tpu_torch.parallel import seqpar
    base = preset("conv_bilstm3")
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(
            base.model, compute_dtype="float32", use_pallas_rnn=False,
            dropout=0.0),
        train=dataclasses.replace(base.train, specaugment=False))
    devices = [torch.device("cuda", 0)] * 2
    rng = np.random.default_rng(41)
    samples = _speechlike(SP_B, SP_S, seed=42)
    slens = torch.as_tensor(rng.integers(SP_S // 2, SP_S + 1, SP_B),
                            dtype=torch.int32)
    slens[0] = SP_S
    labels = torch.as_tensor(rng.integers(0, 28, (SP_B, SP_U)),
                             dtype=torch.int32)
    llens = torch.as_tensor(rng.integers(SP_U // 2, SP_U + 1, SP_B),
                            dtype=torch.int32)
    arrs = [samples, slens.cuda(), labels.cuda(), llens.cuda()]
    # K1 on the first chunk extended by the second's halo
    fc = cfg.features
    ext = samples[:, :SP_S // 2 + fc.win_length - fc.hop_length].contiguous()
    got = stft_cuda.stft_features(ext, fc)
    want = stft_cuda.stft_features_plain(ext, fc)
    k1_err = (got - want).abs().max().item()
    k1_ms = cuda_ms(lambda: stft_cuda.stft_features(ext, fc), reps=20)
    k1_plain_ms = cuda_ms(lambda: stft_cuda.stft_features_plain(ext, fc),
                          reps=20)
    log(f"[sp] K1 on one extended chunk {list(ext.shape)} -> "
        f"{list(got.shape)}: max abs err against the plain version "
        f"{k1_err:.3e} (limit {STFT_TOL}); {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.4f} ms (CUDA events, median of 20); {smi}")
    # one step's gradients both ways from one state
    state = train_mod.init_train_state(cfg, "cuda")
    params = state["params"]
    chunks, sl, lab, ll = seqpar.sp_batch_put(devices, arrs)
    logits, lens = seqpar.sp_encoder(params, chunks, sl, cfg, train=True,
                                     generators=state["generators"])
    loss = ctc_loss(logits, lens, lab, ll,
                    use_kernel=cfg.train.use_pallas_ctc)
    g_sp = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    loss_ref, g_ref = _step_grads(cfg, params, arrs)
    loss_err = abs(loss.item() / loss_ref.item() - 1)
    gn_sp, gn_ref = global_norm(g_sp).item(), global_norm(g_ref).item()
    gn_err = abs(gn_sp / gn_ref - 1)
    cos = {k: torch.nn.functional.cosine_similarity(
        g_sp[k].flatten().double(), g_ref[k].flatten().double(),
        dim=0).item() for k in g_ref}
    worst = min(cos, key=cos.get)
    # eval: the argmax over the unsharded array's frames
    fixed = {k: v.detach() for k, v in params.items()}
    sp_logits, sp_lens = seqpar.make_sp_eval_step(cfg, devices)(
        fixed, samples, arrs[1])
    ref_logits, ref_lens = make_eval_step(cfg, "cuda")(fixed, samples,
                                                       arrs[1])
    T = ref_logits.shape[1]
    valid = (torch.arange(T, device="cuda")[None, :] < ref_lens[:, None])
    agree = ((sp_logits[:, :T].argmax(-1) == ref_logits.argmax(-1))
             & valid).sum().item() / valid.sum().item()
    lens_equal = torch.equal(sp_lens.cpu(), ref_lens.cpu())
    log(f"[sp] B={SP_B} x {SP_S} samples, two chunks on one card, f32, "
        f"plain recurrence: loss {loss.item():.5f} against unsharded "
        f"{loss_ref.item():.5f} (rel err {loss_err:.3e}, limit "
        f"{STEP_LOSS_RTOL}); grad_norm {gn_sp:.5f} against {gn_ref:.5f} "
        f"(rel err {gn_err:.3e}, limit {STEP_GNORM_RTOL}); min per-leaf "
        f"cosine {cos[worst]:.6f} at {worst} (limit {STEP_MIN_COSINE}); eval "
        f"argmax agreement {agree:.5f} (limit {ARGMAX_AGREEMENT}) over "
        f"{T} frames, lengths equal: {lens_equal}")
    del g_sp, g_ref, logits, loss
    # the main path: three SP train steps, counted
    st = train_mod.init_train_state(cfg, "cuda")
    sp_step = seqpar.make_sp_train_step(cfg, devices)
    ms, launches = _count_launches(
        lambda: [sp_step(st, *arrs) for _ in range(3)],
        _LSTM_KERNELS + _GRU_KERNELS)
    losses = [float(m["loss"]) for m in ms]
    log(f"[sp] kernel launches during 3 SP train steps: {launches}; "
        f"losses {losses}")
    times: dict = {}
    for name in ("sp", "unsharded", "unsharded", "sp"):
        st = train_mod.init_train_state(cfg, "cuda")
        step = (seqpar.make_sp_train_step(cfg, devices) if name == "sp"
                else train_mod.make_step_fn(cfg))
        step(st, *arrs)
        times.setdefault(name, []).append(
            _host_ms(lambda: step(st, *arrs), 2))
    log(f"[sp] step ms at B={SP_B} x 3.52 s, f32, plain recurrence (host "
        f"clock, median of 2, sp, unsharded, unsharded, sp): SP over two "
        f"chunks {times['sp']}, unsharded {times['unsharded']}; {smi}")
    bad = []
    if not k1_err <= STFT_TOL:
        bad.append(f"K1 on an SP chunk: {k1_err}")
    if not (loss_err <= STEP_LOSS_RTOL and gn_err <= STEP_GNORM_RTOL
            and cos[worst] >= STEP_MIN_COSINE):
        bad.append(f"SP step against unsharded: loss {loss_err} gnorm "
                   f"{gn_err} cosine {cos[worst]}")
    if not (agree >= ARGMAX_AGREEMENT and lens_equal):
        bad.append(f"SP eval: agreement {agree}, lengths equal {lens_equal}")
    if not np.all(np.isfinite(losses)):
        bad.append(f"SP losses {losses}")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"launches": launches, "k1_err": k1_err, "k1_ms": k1_ms,
            "k1_plain_ms": k1_plain_ms, "times": times}


# ---------------------------------------------------------------------------
# phase 12: the accuracy ladder's runner
# ---------------------------------------------------------------------------

LADDER_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                          "results", "ladder_hard_r4")
LADDER_ARGS = ["--n-train", "64", "--n-dev", "16", "--n-test", "32",
               "--batch", "16", "--steps-scale", "0.02", "--lm-weights", "0.6"]


def _zero(counters: dict) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read(counters: dict) -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def _path_check(tag: str, launches: dict, want: tuple) -> list:
    """Kernels of the path that never launched, and kernels off it that
    did."""
    idle = [k for k in want if launches[k] <= 0]
    stray = [k for k in launches if k not in want and launches[k] > 0]
    if idle or stray:
        return [f"{tag}: never launched {idle}, off the path but launched "
                f"{stray}"]
    return []


def _ladder_counters() -> dict:
    from ctc_asr_tpu_torch.ops import beam_cuda
    c = _train_counters()
    c["beam"] = (beam_cuda.beam_search_decode_cuda, "launches")
    return c


def _decode_kind(decode: str) -> str:
    """A record's decode string without the selected weights' values."""
    return re.sub(r"=[0-9.]+", "=", decode)


def phase_ladder(tmp: str) -> dict:
    """``run_ladder_hard`` in process at full width and tiny scale (64 /
    16 / 32 utterances of the hard corpus, B=16, 2% of the step budgets):
    ``--rungs pr1`` (MFCC, uni-LSTM-256), then ``--rungs ds2,ds3
    --specaug-ab`` on the same corpus, each counted from 0. K1, K2, K3,
    K6 and K7 must launch in both, K8 in the second, K4 and K5 in
    neither; the records and sidecars must carry the reference's
    record keys and sidecar names (``docs/results/ladder_hard_r4``)."""
    from ctc_asr_tpu_torch.scripts import run_ladder_hard
    out = os.path.join(tmp, "ladder")
    arch = os.path.join(tmp, "ladder_archive")
    counters = _ladder_counters()
    runs, records = {}, []
    t0 = time.perf_counter()
    for tag, rungs in (("pr1", ["--rungs", "pr1"]),
                       ("ds2+ds3", ["--rungs", "ds2,ds3", "--specaug-ab"])):
        _zero(counters)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            records += run_ladder_hard.main(
                ["--out", out, "--archive", arch, "--device", "cuda",
                 *LADDER_ARGS, *rungs])
        runs[tag] = _read(counters)
        log(f"[ladder] {tag}: {time.perf_counter() - t1:.1f} s, kernel "
            f"launches {runs[tag]}")
    bad = []
    for tag, launches in runs.items():
        bad += _path_check(tag, launches, tuple(
            k for k in launches if k not in _GRU_KERNELS
            and (k != "beam" or tag != "pr1")))
    with open(os.path.join(LADDER_REF, "ladder_results.jsonl")) as f:
        ref = [json.loads(line) for line in f]
    ref = [r for r in ref if not r["rung"].startswith(
        "deepspeech_beam+specaug")]
    shape = [(r["rung"], _decode_kind(r["decode"]), sorted(r))
             for r in records]
    want = [(r["rung"], _decode_kind(r["decode"]), sorted(r)) for r in ref]
    if shape != want:
        bad.append(f"records {shape} against the reference's {want}")
    names = sorted(os.listdir(os.path.join(arch, "per_utt")))
    ref_names = sorted(n for n in os.listdir(os.path.join(LADDER_REF,
                                                          "per_utt"))
                       if not n.startswith("deepspeech_beam+specaug"))
    if names != ref_names:
        bad.append(f"sidecars {names} against the reference's {ref_names}")
    for n in names:
        with open(os.path.join(arch, "per_utt", n)) as f:
            pu = json.load(f)["per_utt"]
        if len(pu) != 32 or any(len(u) != 4 for u in pu):
            bad.append(f"sidecar {n}: {len(pu)} utterances")
    with open(os.path.join(arch, "ladder_results.jsonl")) as f:
        archived = [json.loads(line) for line in f]
    if archived != records:   # both runs share --out: one archive
        bad.append(f"the archive holds {len(archived)} records, the runs "
                   f"made {len(records)}")
    wers = [r["test_wer"] for r in records]
    if not all(np.isfinite(wers)):
        bad.append(f"test WERs {wers}")
    log(f"[ladder] {len(records)} records, {len(names)} sidecars of 32 "
        f"utterances; test WER {wers}; {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("; ".join(bad))
    total = {k: runs["pr1"][k] + runs["ds2+ds3"][k] for k in counters}
    return {"launches": total, "mfcc_stft": runs["pr1"]["stft"]}


# ---------------------------------------------------------------------------
# phase 13: the OOV rung and the settler on a tiny r4big
# ---------------------------------------------------------------------------

OOV_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                       "results", "oov_r5")
OOV_ARGS = ["--n-bigtest", "32", "--n-oov-dev", "16", "--n-oov-test", "32",
            "--lm-sentences", "512"]


def _oov_label(rec: dict) -> tuple:
    if "compare" in rec:
        return ("compare", rec["compare"], rec["a"], rec["b"])
    return ("arm", rec["arm"], _decode_kind(rec["decode"]), rec["split"])


def phase_oov(tmp: str) -> dict:
    """``run_oov`` in process at full width on a tiny r4big: ``run_ladder_hard
    --rungs ds2sa,ds3sa`` (64 / 16 / 32 utterances, B=16, 2% of the step
    budgets), each arm's last checkpoint copied to ``step_00008000.npz``,
    then ``run_oov`` on 32 / 16 / 32 utterances and LMs of 512 sentences,
    counted from 0: K1, K2 and K8 must launch, K3 to K7 not (it trains
    nothing). The 19 records and the 11 sidecars must carry the
    reference's keys, labels and names (``docs/results/oov_r5``). Then
    ``diag_oov_boundaries`` decodes the OOV test split with each arm
    (ds3+SA greedy and beam 64, ds2+SA greedy): its per-utterance
    records must equal those sidecars."""
    import shutil
    from ctc_asr_tpu_torch.scripts import (diag_oov_boundaries,
                                           run_ladder_hard, run_oov)
    r4big = os.path.join(tmp, "r4big")
    out, arch = os.path.join(tmp, "oov"), os.path.join(tmp, "oov_archive")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run_ladder_hard.main(["--out", r4big, "--device", "cuda",
                              *LADDER_ARGS, "--rungs", "ds2sa,ds3sa"])
    for arm in ("ds2_specaug", "ds3sa"):
        ckpt = os.path.join(r4big, f"train_{arm}", "ckpt")
        last = sorted(os.listdir(ckpt))[-1]
        shutil.copy(os.path.join(ckpt, last),
                    os.path.join(ckpt, "step_00008000.npz"))
    t1 = time.perf_counter()
    counters = _ladder_counters()
    _zero(counters)
    with contextlib.redirect_stdout(io.StringIO()):
        records = run_oov.main(["--r4big", r4big, "--out", out, "--archive",
                                arch, "--device", "cuda", *OOV_ARGS])
    launches = _read(counters)
    t2 = time.perf_counter()
    log(f"[oov] tiny r4big {t1 - t0:.1f} s; run_oov {t2 - t1:.1f} s, kernel "
        f"launches {launches}")
    bad = _path_check("run_oov", launches, ("stft", "lstm_fwd", "beam"))
    with open(os.path.join(OOV_REF, "oov_results.jsonl")) as f:
        ref = [json.loads(line) for line in f]
    shape = [(_oov_label(r), sorted(r)) for r in records]
    want = [(_oov_label(r), sorted(r)) for r in ref]
    if shape != want:
        bad.append(f"records {shape} against the reference's {want}")
    names = sorted(os.listdir(os.path.join(arch, "per_utt")))
    ref_names = sorted(os.listdir(os.path.join(OOV_REF, "per_utt")))
    if names != ref_names:
        bad.append(f"sidecars {names} against the reference's {ref_names}")
    for n in names:
        with open(os.path.join(arch, "per_utt", n)) as f:
            pu = json.load(f)["per_utt"]
        if len(pu) != 32 or any(len(u) != 4 for u in pu):
            bad.append(f"sidecar {n}: {len(pu)} utterances")
    wers = [r["test_wer"] for r in records if "test_wer" in r]
    if len(wers) != 11 or not all(np.isfinite(wers)):
        bad.append(f"test WERs {wers}")
    log(f"[oov] {len(records)} records, {len(names)} sidecars of 32 "
        f"utterances; test WER {wers}")
    t3 = time.perf_counter()
    for arm, preset_name, decode in (("ds3sa", "deepspeech_beam", "greedy"),
                                     ("ds3sa", "deepspeech_beam", "beam64"),
                                     ("ds2_specaug", "conv_bilstm3",
                                      "greedy")):
        tag = {"ds3sa": "ds3sa8000", "ds2_specaug": "ds2sa8000"}[arm]
        tag = f"oov_{tag}_{'beam' if decode == 'beam64' else 'greedy'}"
        diag_out = os.path.join(tmp, "diag", tag + ".json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = diag_oov_boundaries.main([
                "--preset", preset_name, "--ckpt",
                os.path.join(r4big, f"train_{arm}", "ckpt",
                             "step_00008000.npz"),
                "--manifest", os.path.join(out, "oov_test.csv"),
                "--vocab-manifest", os.path.join(r4big, "corpus",
                                                 "train.csv"),
                "--decode", decode, "--sidecar",
                os.path.join(out, "per_utt", tag + ".json"),
                "--out", diag_out, "--device", "cuda"])
        with open(diag_out) as f:
            summ = json.load(f)["summary"]
        if rc != 0 or not summ["matches_sidecar"] or summ["utterances"] != 32:
            bad.append(f"diag_oov_boundaries {tag}: rc {rc}, "
                       f"{summ['utterances']} utterances, matches the "
                       f"sidecar: {summ['matches_sidecar']}")
        log(f"[oov] diag {tag}: records equal the sidecar's "
            f"{summ['matches_sidecar']}; oov words {summ['oov']['words']}, "
            f"split {summ['oov']['split_words']}, boundaries dropped "
            f"{summ['oov']['boundaries_dropped_after']}")
    log(f"[oov] diag_oov_boundaries, three decodes: "
        f"{time.perf_counter() - t3:.1f} s")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 14: the round-1 synth runners
# ---------------------------------------------------------------------------

SYNTH_RUNS = [
    ("run_synth_e2e", ["--steps", "40"]),
    ("run_synth_ds2", ["--steps", "40"]),
    ("run_synth_lm", []),
    ("run_synth_ds3", ["--steps", "20"]),
    ("run_synth_holdout", ["--steps", "40", "--specaugment"]),
]
# the reference's JSON keys (scripts/run_synth_*.py)
SYNTH_KEYS = {
    "run_synth_e2e": ["train_steps", "train_wall_s"] + [
        f"{t}_{m}" for t in ("greedy", "beam_xla", "beam_pallas")
        for m in ("wer", "cer", "rtf")],
    "run_synth_ds2": ["train_steps", "train_wall_s", "greedy_wer",
                      "greedy_rtf", "beam_pallas_wer", "beam_pallas_rtf"],
    "run_synth_lm": [f"{t}_{m}" for t in ("beam", "beam_charlm",
                                           "beam_rescored")
                     for m in ("wer", "cer", "rtf")],
    "run_synth_ds3": ["train_steps", "train_wall_s", "beam64_pallas_wer",
                      "beam64_rtf"],
    "run_synth_holdout": ["train_steps", "train_wall_s", "train_utts",
                          "heldout_utts", "heldout_wer", "heldout_cer",
                          "beam_rtf", "specaugment"],
}


def phase_synth(tmp: str) -> dict:
    """The five round-1 synth runners in process at full width and their
    default corpora, a few tens of steps each (``run_synth_lm`` on
    ``run_synth_ds2``'s checkpoint), counted from 0 together: K1, K2,
    K3, K6, K7 and K8 must launch, K4 and K5 not. Each must return the
    reference's JSON keys; in e2e the plain beam search and K8 must give
    the same WER and CER (the same beams), and greedy's is reported."""
    import importlib
    counters = _ladder_counters()
    _zero(counters)
    ds2 = os.path.join(tmp, "synth_ds2")
    bad, res = [], {}
    t0 = time.perf_counter()
    for name, argv in SYNTH_RUNS:
        mod = importlib.import_module(f"ctc_asr_tpu_torch.scripts.{name}")
        work = ["--dir", ds2] if name == "run_synth_lm" else [
            "--out", ds2 if name == "run_synth_ds2"
            else os.path.join(tmp, name)]
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res[name] = mod.main([*argv, *work, "--device", "cuda"])
        log(f"[synth] {name} {time.perf_counter() - t1:.1f} s: "
            f"{json.dumps(res[name])}")
        if sorted(res[name]) != sorted(SYNTH_KEYS[name]):
            bad.append(f"{name}: keys {sorted(res[name])}")
    launches = _read(counters)
    log(f"[synth] {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{launches}")
    bad += _path_check("synth runners", launches,
                       ("stft", "lstm_fwd", "lstm_bwd", "ctc_alpha",
                        "ctc_beta_grad", "beam"))
    e2e = res["run_synth_e2e"]
    if (e2e["beam_xla_wer"], e2e["beam_xla_cer"]) != (
            e2e["beam_pallas_wer"], e2e["beam_pallas_cer"]):
        bad.append(f"e2e: the plain beam and K8 disagree: {e2e}")
    log(f"[synth] e2e WER greedy {e2e['greedy_wer']}, plain beam "
        f"{e2e['beam_xla_wer']}, K8 beam {e2e['beam_pallas_wer']}")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"launches": launches}


def _eval_json(out: str) -> dict:
    return json.loads(out[out.index("\n{") + 1:])


def phase_decode(tmp: str, manifest: str, train_dir: str) -> dict:
    """The decode slice at full ``lm_fusion_960h`` width on the card."""
    import torch
    from ctc_asr_tpu_torch.checkpoint import load_params
    from ctc_asr_tpu_torch.config import apply_overrides, preset
    from ctc_asr_tpu_torch.data import DataLoader, read_manifest
    from ctc_asr_tpu_torch.evaluate import (make_decoder, make_eval_step,
                                            make_nbest_decoder)
    from ctc_asr_tpu_torch.ops import beam_cuda, lstm_cuda, stft_cuda
    from ctc_asr_tpu_torch.transcribe import Transcriber

    t0 = time.perf_counter()
    lm_path = os.path.join(tmp, "char_lm.npz")
    wlm_path = os.path.join(tmp, "word_lm.pkl")
    run_cli(["train-lm", "--manifest", manifest, "--out", lm_path,
             "--order", "4"])
    run_cli(["train-lm", "--manifest", manifest, "--out", wlm_path,
             "--order", "2", "--words"])
    ckpt = os.path.join(tmp, "ds3_step_00000000.npz")
    data = {"data.eval_manifest": manifest, "data.batch_size": "16",
            "data.num_buckets": "1"}
    cfg = apply_overrides(preset("lm_fusion_960h"),
                          {**data, "decode.lm_path": lm_path})
    random_checkpoint(cfg, ckpt, seed=1)
    log(f"[decode] LMs + 5 x BiLSTM-800 checkpoint in "
        f"{time.perf_counter() - t0:.1f} s")
    wavs = [u.path for u in read_manifest(manifest)][:2]

    def flags(extra):
        return [f"--{k}={v}" for k, v in {**data, **extra}.items()]

    counters = {"stft": stft_cuda.stft_features, "lstm_fwd": lstm_cuda.lstm_fwd,
                "beam": beam_cuda.beam_search_decode_cuda}
    for fn in counters.values():
        fn.launches = 0
    ds3 = ["--ckpt", ckpt, "--device=cuda"]
    fusion = {"decode.lm_path": lm_path}
    runs = {
        "beam + fusion": ["evaluate", "--preset", "lm_fusion_960h", *ds3,
                          *flags(fusion)],
        "beam + fusion + rescoring": [
            "evaluate", "--preset", "lm_fusion_960h", *ds3,
            *flags({**fusion, "decode.word_lm_path": wlm_path})],
        "beam": ["evaluate", "--preset", "deepspeech_beam", *ds3, *flags({})],
        "greedy": ["evaluate", "--preset", "deepspeech_beam", *ds3,
                   *flags({"decode.method": "greedy"})],
    }
    rtf = {}
    for mode, argv in runs.items():
        res = _eval_json(run_cli(argv))
        rtf[mode] = res["rtf"]
        log(f"[decode] ds3 {mode}: rtf={res['rtf']:.6f} rtf_incl_compile="
            f"{res['rtf_incl_compile']:.6f} wer={res['wer']:.4f} (random "
            f"weights) utterances={res['utterances']}")
        if res["utterances"] < 48 or not np.isfinite(res["rtf"]):
            raise AssertionError(f"decode {mode}: {res}")
    for mode, extra in (("greedy", {"decode.method": "greedy"}), ("beam", {}),
                        ("beam + fusion", fusion)):
        out = run_cli(["transcribe", "--preset", "lm_fusion_960h", *ds3,
                       *flags(extra), *wavs])
        if len([ln for ln in out.splitlines() if "\t" in ln]) != len(wavs):
            raise AssertionError(f"transcribe ({mode}) printed no result")
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"[decode] kernel launches during the decode slice: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the decode path never launched: "
                             f"{launches}")

    # K1 and K2 at this path's shapes ([16, 56320] samples, H=800, 5
    # layers) against the plain path, then every eval batch's logits
    # through K8 and the plain beam search
    params = load_params(ckpt, cfg, "cuda")
    paths_agreement("decode", cfg, params, manifest)
    eval_step = make_eval_step(cfg, "cuda")
    plain_cfg = dataclasses.replace(cfg, decode=dataclasses.replace(
        cfg.decode, use_pallas=False))
    kernel_beam = make_decoder(cfg, return_nbest=True)
    plain_beam = make_decoder(plain_cfg, return_nbest=True)
    loader = DataLoader(read_manifest(manifest), cfg.data, cfg.features,
                        drop_last=False)
    nbest_decode, pick_best = make_nbest_decoder(apply_overrides(
        cfg, {"decode.word_lm_path": wlm_path}))
    excused, rows, err = 0, 0, 0.0
    split = {"host load": [], "features + encoder": [], "K8": [],
             "host rescoring": []}

    def lap(name, since):
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[name].append((now - since) * 1e3)
        return now

    t1 = time.perf_counter()
    for batch in loader.iter_epoch(0):
        t1 = lap("host load", t1)
        logits, lens = eval_step(params, batch.samples, batch.sample_lengths)
        t1 = lap("features + encoder", t1)
        nbest = nbest_decode(logits, lens)
        t1 = lap("K8", t1)
        pick_best(*nbest)
        lap("host rescoring", t1)
        if not torch.isfinite(logits).all() \
                or logits.shape[2] != cfg.model.num_classes:
            raise AssertionError("bad ds3 logits")
        agree = beam_agreement(kernel_beam(logits, lens),
                               plain_beam(logits, lens))
        excused += agree["excused"]
        rows += logits.shape[0]
        err = max(err, agree["max_rel_err"])
        t1 = time.perf_counter()
    log(f"[decode] K8 vs plain beam on the ds3 logits (fusion, N-best): "
        f"{rows} rows, excused by the tie rule {excused}, score rel err "
        f"{err:.3e}")
    log(f"[decode] ds3 fusion + rescoring, ms a batch of 16 x "
        f"{logits.shape[1]} frames (host clock, synchronized, median of "
        f"the batches after the first): "
        + ", ".join(f"{k} {statistics.median(v[1:]):.2f}"
                    for k, v in split.items()))

    # B=1 latency per request, host clock around a synchronized call
    lat = {}
    for mode, extra in (("greedy", {"decode.method": "greedy"}),
                        ("beam", {"decode.lm_path": ""}), ("beam + fusion", {})):
        tr = Transcriber(apply_overrides(cfg, extra), params, "cuda")
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tr.transcribe_file(wavs[i % len(wavs)])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        lat[mode] = statistics.median(times[1:])
    log("[decode] ds3 B=1 latency per request (ms, median of 5 after one "
        "warm-up, wav read included): "
        + ", ".join(f"{k} {v:.2f}" for k, v in lat.items()))

    # the trained conv_bilstm3 checkpoint, whose posteriors have structure
    res = _eval_json(run_cli(
        ["evaluate", "--preset", "conv_bilstm3", "--ckpt", train_dir,
         "--device=cuda", *flags({"decode.method": "beam",
                                  "decode.lm_path": lm_path})]))
    log(f"[decode] conv_bilstm3 step-40 checkpoint, beam + fusion: "
        f"wer={res['wer']:.4f} cer={res['cer']:.4f} rtf={res['rtf']:.6f}")
    return {"launches": launches, "rtf": rtf, "latency_ms": lat,
            "excused": excused}


def _step_grads(cfg, params, arrs, mark=lambda: None):
    """(loss, {k: grad}) of one train step's loss on the given path, its
    convs on cuDNN's deterministic algorithms as in ``make_step_fn``;
    ``mark()`` is called after features, encoder, CTC and backward."""
    import torch
    from ctc_asr_tpu_torch.features import extract_features
    from ctc_asr_tpu_torch.models import apply_encoder
    from ctc_asr_tpu_torch.models.layers import deterministic_convs
    from ctc_asr_tpu_torch.ops.ctc_cuda import ctc_loss
    samples, slens, labels, llens = arrs
    with deterministic_convs():
        with torch.no_grad():
            feats, flens = extract_features(samples, slens, cfg.features)
        mark()
        logits, lens = apply_encoder(params, feats, flens, cfg.model,
                                     train=True)
        mark()
        loss = ctc_loss(logits, lens, labels, llens,
                        use_kernel=cfg.train.use_pallas_ctc)
        mark()
        grads = torch.autograd.grad(loss, list(params.values()))
        mark()
    return loss.detach(), dict(zip(params, grads))


# device kernels of a train step, by layer: first the frontend's (every
# kernel its forward range or the autograd nodes that range created
# launched, whichever conv form runs), then by name (the first match)
_FRONTEND_GROUP = "frontend convs, fwd + bwd"
_KERNEL_GROUPS = (
    ("K3 lstm_bwd", ("lstm_bwd_persistent_kernel",)),
    ("K2 lstm_fwd", ("lstm_fwd_persistent_kernel",)),
    ("K5 gru_bwd", ("gru_bwd_persistent_kernel",)),
    ("K4 gru_fwd", ("gru_fwd_persistent_kernel",)),
    ("K1 stft", ("stft_mel_kernel", "stft_dft_kernel")),
    ("K6+K7 ctc", ("ctc_alpha_kernel", "ctc_beta_grad_kernel")),
    ("cuBLAS matmuls", ("gemm", "nvjet", "cutlass")),
)
# conv kernels by name (cuDNN's and CUTLASS's forward, data- and
# weight-gradient kernels and layout transforms): a check that the
# frontend group holds them all
_CONV_NAMES = ("fprop", "dgrad", "wgrad", "Convolution", "nhwc", "Nhwc",
               "nchw", "Nchw")


def _frontend_kernels(evs) -> set:
    """Ids of the device events launched inside the encoder's frontend
    range (``encoder.FRONTEND_RANGE``) or inside the backward of an
    autograd node that range created (matched by sequence number). A
    kernel is tied to its launch (the runtime call that shares its
    correlation id), and the launch to the op ranges that contain it on
    the launching thread's clock."""
    from torch.autograd import DeviceType
    from ctc_asr_tpu_torch.models.encoder import FRONTEND_RANGE
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    launches = {e.id: e for e in cpu if e.name.startswith("cu")}

    def inside(e, spans):
        t = e.time_range.start
        return any(e.thread == th and r.start <= t <= r.end
                   for th, r in spans)
    fronts = [(e.thread, e.time_range) for e in cpu
              if e.name == FRONTEND_RANGE]
    fwd_seq = {e.sequence_nr for e in cpu
               if e.sequence_nr >= 0 and inside(e, fronts)}
    spans = fronts + [(e.thread, e.time_range) for e in cpu
                      if "Backward" in e.name and e.sequence_nr in fwd_seq]
    return {id(e) for e in evs if e.device_type == DeviceType.CUDA
            and e.id in launches and inside(launches[e.id], spans)}


def _profile_step(cfg, arrs, tag: str = "profile") -> dict:
    """Where a kernel-path train step's time goes: CUDA events between
    its phases (median of 5 steps after one warm-up), then
    ``torch.profiler`` over 3 steps after a traced one that is thrown
    away: device time per kernel group, and
    the device's busy share (the union of its kernel and copy intervals
    over the event-timed step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.optim import Adam
    state = train_mod.init_train_state(cfg, "cuda")
    opt = Adam(cfg.train)
    names = ("features", "encoder_fwd", "ctc_fwd", "backward", "optimizer")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    splits = []
    for _ in range(6):
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        it = iter(evs)
        next(it).record()
        _, grads = _step_grads(cfg, state["params"], arrs,
                               mark=lambda: next(it).record())
        opt.step(state["params"], grads, state["opt_state"])
        next(it).record()
        torch.cuda.synchronize()
        splits.append([a.elapsed_time(b) for a, b in zip(evs, evs[1:])])
    split = {n: statistics.median(s[i] for s in splits[1:])
             for i, n in enumerate(names)}
    step_ms = sum(split.values())
    peak = torch.cuda.max_memory_allocated() / 2**30

    step = train_mod.make_step_fn(cfg)
    reps = 3
    # the first traced step is thrown away (the first kernel after the
    # tracer starts, K1, often went unrecorded), and only kernels from
    # the start of the measured range on the device's clock are counted:
    # the host's clock is offset from it by enough to drop a step's first
    # kernels
    def run():
        step(state, *arrs)
        torch.cuda.synchronize()
        with record_function("measured steps"):
            for _ in range(reps):
                step(state, *arrs)
            torch.cuda.synchronize()

    # the host clock's start would drop the range's first kernels, and
    # the range's own device-side mark covers only kernels launched
    # outside the spans nested in it (train.step's holds them all): the
    # range starts at the first kernel whose launch (the runtime call
    # that shares its correlation id) lies inside it on the host's clock
    def first_start(evs):
        cpu = [e for e in evs if e.device_type == DeviceType.CPU]
        ranges = [e.time_range for e in cpu if e.name == "measured steps"]
        launches = {e.id: e.time_range.start for e in cpu
                    if e.name.startswith("cu")}
        return min((e.time_range.start for e in evs
                    if e.device_type == DeviceType.CUDA
                    and e.id in launches
                    and any(r.start <= launches[e.id] <= r.end
                            for r in ranges)), default=None)
    evs = _trace(run, lambda evs: first_start(evs) is not None,
                 "kernel launched inside 'measured steps'")
    t0 = first_start(evs)
    kernels = [e for e in evs
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "Command Buffer" not in e.name
               and e.time_range.start >= t0]
    frontend = _frontend_kernels(evs)
    stray = [e for e in kernels if id(e) not in frontend
             and any(k in e.name for k in _CONV_NAMES)]
    log(f"[{tag}] conv kernels by name outside the frontend group: "
        f"{len(stray) // reps} a step, "
        f"{sum(e.time_range.elapsed_us() for e in stray) / 1e3 / reps:.3f} "
        f"ms a step {sorted({e.name[:60] for e in stray})[:3]}")
    groups: dict = {}
    for e in kernels:
        label = _FRONTEND_GROUP if id(e) in frontend else next(
            (g for g, keys in _KERNEL_GROUPS
             if any(k in e.name for k in keys)),
            "elementwise, copies, other")
        ms, n = groups.get(label, (0.0, 0))
        groups[label] = (ms + e.time_range.elapsed_us() / 1e3 / reps,
                         n + 1)
    busy_us, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
    busy_ms = busy_us / 1e3 / reps
    log(f"[{tag}] kernel-path step at B=128 x 8 s, CUDA events "
        f"(median of 5): {step_ms:.2f} ms; "
        + ", ".join(f"{n} {v:.2f}" for n, v in split.items())
        + f"; peak device memory {peak:.2f} GiB")
    log(f"[{tag}] torch.profiler over {reps} steps (from the device "
        f"clock's start of the range): device busy {busy_ms:.2f} ms a step = "
        f"{busy_ms / step_ms:.3f} of the event-timed step")
    total = sum(ms for ms, _ in groups.values())
    for label, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[{tag}]   {label}: {ms:.2f} ms a step, {n // reps} "
            f"launches a step, {ms / total:.3f} of kernel time")
    if not kernels:
        raise AssertionError("torch.profiler recorded no device kernel")
    return {"step_ms": step_ms, "split": split, "busy_ms": busy_ms,
            "groups": groups, "peak_gib": peak}


REPRO_STEPS = 20
STRICT_TIMEOUT_S = 300  # the strict-mode child's whole run


def _repro_pair(tmp: str, manifest: str, rnn_type: str) -> dict:
    """Two ``cli train`` runs of ``conv_bilstm3`` at full width with the
    given cell, B=16, two length buckets, dropout (the preset's 0.05)
    and SpecAugment on, seed 42, REPRO_STEPS steps each, one with
    ``--train.precompile=true`` and one with ``false``, counted from 0
    together. Every logged loss, gradient norm and rate and every array
    of the final checkpoint (parameters, Adam moments, count, step,
    generators) must be bit-equal, both buckets trained and the warm-up
    line printed by the first run alone."""
    overrides = {"data.train_manifest": manifest, "data.batch_size": "16",
                 "data.num_buckets": "2", "model.rnn_type": rnn_type,
                 "train.specaugment": "true", "train.learning_rate": "3e-4",
                 "train.log_every": "1", "train.sync_every": "4",
                 "train.eval_every": "0",
                 "train.checkpoint_every": str(REPRO_STEPS),
                 "train.total_steps": str(REPRO_STEPS)}
    runs, warm = {}, {}

    def run():
        for on in ("true", "false"):
            tdir = os.path.join(tmp, f"repro_{rnn_type}_{on}")
            t0 = time.perf_counter()
            out = run_cli(
                ["train", "--preset", "conv_bilstm3", "--device=cuda",
                 f"--train.train_dir={tdir}", f"--train.precompile={on}"]
                + [f"--{k}={v}" for k, v in overrides.items()])
            wall = time.perf_counter() - t0
            m = re.search(r"\[train\] precompiled 2 bucket shapes in "
                          r"[\d.]+s", out)
            warm[on] = (m.group(0) if m else None, wall)
            recs = _read_metrics(tdir)
            path = os.path.join(tdir, "ckpt", f"step_{REPRO_STEPS:08d}.npz")
            with np.load(path) as z:
                runs[on] = ({k: (r["loss"], r["grad_norm"], r["lr"],
                                 r["bucket"]) for k, r in recs.items()},
                            {k: z[k] for k in z.files})

    _, launches = _count_launches(
        run, _GRU_KERNELS if rnn_type == "lstm" else _LSTM_KERNELS)
    (rec_on, flat_on), (rec_off, flat_off) = runs["true"], runs["false"]
    diff = sorted(k for k in set(flat_on) | set(flat_off)
                  if k not in flat_on or k not in flat_off
                  or not np.array_equal(flat_on[k], flat_off[k]))
    same_recs = rec_on == rec_off
    buckets = sorted({r[3] for r in rec_on.values()})
    log(f"[repro {rnn_type}] cli train x 2, B=16, 2 buckets, dropout 0.05 + "
        f"SpecAugment, seed 42, {REPRO_STEPS} steps: precompile=true "
        f"{warm['true'][1]:.1f} s ({warm['true'][0]!r}), precompile=false "
        f"{warm['false'][1]:.1f} s; buckets trained {buckets}; logged "
        f"loss / grad_norm / lr bit-equal: {same_recs}; checkpoint arrays "
        f"{len(flat_on)}, differing: {diff[:8]}; launches {launches}")
    if not (same_recs and not diff and sorted(rec_on) == list(
            range(1, REPRO_STEPS + 1)) and buckets == [0, 1]
            and warm["true"][0] and not warm["false"][0]):
        raise AssertionError(f"{rnn_type}: the precompile=true and false "
                             f"runs differ or did not run as set")
    return launches


def _strict_step() -> dict:
    """One B=128 x 8 s ``conv_bilstm3`` LSTM step from the seed's state:
    its loss, gradient norm and a digest of the parameters after it."""
    import torch
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.config import preset
    cfg = preset("conv_bilstm3")
    st = train_mod.init_train_state(cfg, "cuda")
    m = train_mod.make_step_fn(cfg)(st, *_step_batch())
    torch.cuda.synchronize()
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "digest": _params_digest(st["params"])}


def strict_worker(argv) -> int:
    """``--strict-worker``: ``_strict_step`` under
    ``torch.use_deterministic_algorithms(True)``, which raises at any op
    of the step that has no deterministic implementation on the card
    (the parent sets ``CUBLAS_WORKSPACE_CONFIG``, which strict mode asks
    of cuBLAS)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    print("[repro strict] " + json.dumps(_strict_step()), flush=True)
    return 0


def _step_twice(rnn_type: str) -> tuple:
    """Two runs of three B=128 x 8 s steps of ``conv_bilstm3`` with the
    given cell from the seed's state: (bits equal, ms of each timed
    step, the first step's digest)."""
    import torch
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.config import preset
    cfg = preset("conv_bilstm3")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rnn_type=rnn_type))
    arrs = _step_batch()
    digests, ms, first = [], [], None
    for _ in range(2):
        st = train_mod.init_train_state(cfg, "cuda")
        step = train_mod.make_step_fn(cfg)
        losses = [step(st, *arrs)["loss"]]
        first = first or _params_digest(st["params"])
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(st, *arrs)["loss"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        digests.append((_params_digest(st["params"]),
                        _params_digest(st["opt_state"]["mu"]),
                        _params_digest(st["opt_state"]["nu"]),
                        [v.item() for v in losses]))
    return digests[0] == digests[1], ms, first


def phase_repro(tmp: str, manifest: str, smi: str) -> dict:
    """A run on the card reproduces from its seed (ROADMAP C18): the
    ``cli train`` pairs of ``_repro_pair`` for the LSTM and the GRU
    (``train.precompile`` on against off); two runs of three B=128 x 8 s
    steps from the seed's state, bit-equal, for each cell, with the
    steps' times; and one such LSTM step under strict
    ``torch.use_deterministic_algorithms(True)`` in a child process,
    which must raise nothing (its bits beside the default step's)."""
    launches = {cell: _repro_pair(tmp, manifest, cell)
                for cell in ("lstm", "gru")}
    step = {cell: _step_twice(cell) for cell in ("lstm", "gru")}
    for cell, (equal, ms, _) in step.items():
        log(f"[repro {cell}] B=128 x 8 s, three steps from the seed's state "
            f"twice: parameters, moments and losses bit-equal: {equal}; ms "
            f"a step (host clock, steps 2-3 of each run) {ms}; {smi}")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--strict-worker"], env=env, capture_output=True,
                       text=True, timeout=STRICT_TIMEOUT_S)
    if p.returncode != 0:
        raise RuntimeError(f"the strict-mode step raised (exit "
                           f"{p.returncode}):\n{(p.stdout + p.stderr)[-6000:]}")
    strict = json.loads(p.stdout.split("[repro strict] ", 1)[1]
                        .splitlines()[0])
    log(f"[repro strict] B=128 x 8 s LSTM step under "
        f"torch.use_deterministic_algorithms(True), "
        f"CUBLAS_WORKSPACE_CONFIG=:4096:8: raised nothing; loss "
        f"{strict['loss']:.6f} grad_norm {strict['grad_norm']:.6f}; "
        f"parameters bit-equal to the default step's: "
        f"{strict['digest'] == step['lstm'][2]}")
    if not all(equal for equal, _, _ in step.values()):
        raise AssertionError("a B=128 step is not bit-equal to itself")
    return {"launches": launches,
            "step_ms": {c: statistics.median(v[1]) for c, v in step.items()}}


def _step_batch() -> list:
    """The bench geometry's batch on the card: B=128 x 8 s of seeded
    speech-like samples, ragged lengths, U=96 labels."""
    import torch
    B, S, U = 128, 128000, 96
    rng = np.random.default_rng(11)
    samples = _speechlike(B, S, seed=12)
    slens = torch.as_tensor(rng.integers(S // 2, S + 1, B), dtype=torch.int32)
    slens[0] = S
    labels = torch.as_tensor(rng.integers(0, 28, (B, U)), dtype=torch.int32)
    llens = torch.as_tensor(rng.integers(U // 2, U + 1, B), dtype=torch.int32)
    return [samples, slens.cuda(), labels.cuda(), llens.cuda()]


def phase_step(rnn_type: str = "lstm") -> dict:
    """One step at B=128 x 8 s from one random state (dropout 0) of the
    ``conv_bilstm3`` model with the given cell: the kernel path's loss,
    gradient norm and per-leaf gradient cosines against the plain path at f32 compute (and, for information, at
    bf16), and the step's time on the kernel and the bf16 plain path."""
    import torch
    from ctc_asr_tpu_torch.config import preset
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.optim import global_norm
    tag = "step" if rnn_type == "lstm" else f"{rnn_type} step"
    base = preset("conv_bilstm3")
    base = dataclasses.replace(
        base, model=dataclasses.replace(base.model, dropout=0.0,
                                        rnn_type=rnn_type))
    plain = dataclasses.replace(
        base, features=dataclasses.replace(base.features, use_pallas=False),
        model=dataclasses.replace(base.model, use_pallas_rnn=False),
        train=dataclasses.replace(base.train, use_pallas_ctc=False))
    plain32 = dataclasses.replace(plain, model=dataclasses.replace(
        plain.model, compute_dtype="float32"))
    arrs = _step_batch()
    state = train_mod.init_train_state(base, "cuda")
    out = {}
    for name, cfg in (("kernel", base), ("plain_f32", plain32),
                      ("plain_bf16", plain)):
        loss, grads = _step_grads(cfg, state["params"], arrs)
        out[name] = (loss.item(), grads, global_norm(grads).item())

    def compare(ref):
        loss_err = abs(out["kernel"][0] / out[ref][0] - 1)
        gn_err = abs(out["kernel"][2] / out[ref][2] - 1)
        cos = {k: torch.nn.functional.cosine_similarity(
            out["kernel"][1][k].flatten().double(),
            out[ref][1][k].flatten().double(), dim=0).item()
            for k in out[ref][1]}
        worst = min(cos, key=cos.get)
        log(f"[{tag}] B=128 x 8 s, U=96, kernel vs {ref}: loss "
            f"{out['kernel'][0]:.4f} vs {out[ref][0]:.4f} rel err "
            f"{loss_err:.3e}; grad_norm {out['kernel'][2]:.4f} vs "
            f"{out[ref][2]:.4f} rel err {gn_err:.3e}; min per-leaf cosine "
            f"{cos[worst]:.6f} at {worst}")
        return loss_err, gn_err, cos[worst]

    loss_err, gn_err, min_cos = compare("plain_f32")
    compare("plain_bf16")
    times = {}
    for name, cfg in (("kernel", base), ("plain", plain), ("plain", plain),
                      ("kernel", base)):
        st = train_mod.init_train_state(cfg, "cuda")
        step = train_mod.make_step_fn(cfg)
        step(st, *arrs)                                   # first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(st, *arrs)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(
            (time.perf_counter() - t0) / 2 * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] limits against plain_f32: loss {STEP_LOSS_RTOL}, grad_norm "
        f"{STEP_GNORM_RTOL}, cosine >= {STEP_MIN_COSINE}")
    log(f"[{tag}] ms per step (kernel, plain, plain, kernel order): "
        f"kernel {times['kernel']} plain {times['plain']}; peak device "
        f"memory {peak:.2f} GiB")
    if not (loss_err <= STEP_LOSS_RTOL and gn_err <= STEP_GNORM_RTOL
            and min_cos >= STEP_MIN_COSINE):
        raise AssertionError(f"kernel vs plain step: loss {loss_err} "
                             f"gnorm {gn_err} cosine {min_cos}")
    # the default conv (the blocked band) against the 2-D conv that
    # --model.conv_as_matmul=false selects, in turns on the kernel path
    conv2d = dataclasses.replace(base, model=dataclasses.replace(
        base.model, conv_as_matmul=False))
    ab: dict = {}
    for name, cfg in (("default", base), ("2-D", conv2d), ("2-D", conv2d),
                      ("default", base)):
        st = train_mod.init_train_state(cfg, "cuda")
        step = train_mod.make_step_fn(cfg)
        step(st, *arrs)                                   # first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(st, *arrs)
        torch.cuda.synchronize()
        ab.setdefault(name, []).append((time.perf_counter() - t0) / 5 * 1e3)
    log(f"[{tag}] ms per step, host clock over 5 steps (default, 2-D, 2-D, "
        f"default order): default conv (--model.conv_as_matmul=true "
        f"--model.conv_blocked_fwd=true) {ab['default']}, "
        f"--model.conv_as_matmul=false {ab['2-D']}")
    ptag = "profile" if rnn_type == "lstm" else f"{rnn_type} profile"
    prof = _profile_step(base, arrs, ptag)
    prof_2d = _profile_step(conv2d, arrs, f"{ptag}, conv_as_matmul=false")
    return {"kernel_ms": min(times["kernel"]),
            "plain_ms": min(times["plain"]), "default_ms": ab["default"],
            "conv2d_ms": ab["2-D"],
            "frontend_ms": prof["groups"][_FRONTEND_GROUP][0],
            "frontend_conv2d_ms": prof_2d["groups"][_FRONTEND_GROUP][0]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import ctc_asr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    # the plain references run in full f32 (cuDNN convs default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        name = phase.__name__ + (f"({args[0]})" if phase is phase_step
                                 else "")
        log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    dev = timed(phase_device)
    timed(phase_build)
    k1 = timed(phase_stft)
    k2 = timed(phase_lstm)
    k67 = timed(phase_ctc)
    k23 = timed(phase_lstm_train)
    sel_us = timed(phase_select)
    k8 = timed(phase_beam)
    k8["selection_us"] = sel_us
    k45 = timed(phase_gru)
    k5_f64 = timed(phase_gru_f64)
    conv = timed(phase_conv)
    k9 = timed(phase_attention)
    with tempfile.TemporaryDirectory() as tmp:
        sl = timed(phase_slice, tmp)
        tr = timed(phase_train, tmp, sl["manifest"])
        dec = timed(phase_decode, tmp, sl["manifest"], tr["train_dir"])
        gru = timed(phase_gru_slice, tmp, sl["manifest"])
        timed(phase_datatools, tmp, sl["manifest"], gru)
        rep = timed(phase_repro, tmp, sl["manifest"], dev["smi"])
        timed(phase_dp, tmp, sl["manifest"], tr["step_s"], dev["smi"])
        tp = timed(phase_tp, tmp, sl["manifest"], dev["smi"])
        lad = timed(phase_ladder, tmp)
        ool = timed(phase_oov, tmp)["launches"]
        syl = timed(phase_synth, tmp)["launches"]
    sp = timed(phase_sp, dev["smi"])
    step = timed(phase_step, "lstm")
    gru_step = timed(phase_step, "gru")
    tl, dl, gl = tr["launches"], dec["launches"], gru["launches"]
    tpl, spl = tp["launches"][0], sp["launches"]
    k3_yardsticks = k2.pop("bwd")
    # launches: the train run's (for K4/K5 the GRU train run's), the
    # serving run's, the decode run's, the GRU train run's, the TP, SP and
    # ladder runs', each counted from 0 over its own run
    ll = lad["launches"]
    kernels = [
        {"name": "stft_mel", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/stft.cu",
         "replaces": "ctc_asr_tpu/ops/stft_pallas.py:102",
         "launches": tl["stft"], "serve_launches": sl["launches"]["stft"],
         "decode_launches": dl["stft"], "gru_launches": gl["stft"],
         "tp_launches": tpl["stft"], "sp_launches": spl["stft"],
         "sp_chunk_max_abs_err": sp["k1_err"], "sp_chunk_ms": sp["k1_ms"],
         "sp_chunk_plain_ms": sp["k1_plain_ms"],
         "ladder_launches": ll["stft"],
         "ladder_mfcc_launches": lad["mfcc_stft"], **k1},
        {"name": "lstm_fwd", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/lstm_fwd.cu",
         "replaces": "ctc_asr_tpu/ops/lstm_pallas.py:199",
         "launches": tl["lstm_fwd"], "serve_launches": sl["launches"]["lstm"],
         "decode_launches": dl["lstm_fwd"], "tp_launches": tpl["lstm_fwd"],
         "sp_launches": spl["lstm_fwd"], "ladder_launches": ll["lstm_fwd"],
         **k2, **{"residual_" + k: v
                  for k, v in k23["lstm_fwd_res"].items()
                  if k != "max_abs_err"}},
        {"name": "lstm_bwd", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/lstm_bwd.cu",
         "replaces": "ctc_asr_tpu/ops/lstm_pallas.py:247",
         "launches": tl["lstm_bwd"], "tp_launches": tpl["lstm_bwd"],
         "sp_launches": spl["lstm_bwd"], "ladder_launches": ll["lstm_bwd"],
         **k23["lstm_bwd"],
         **k3_yardsticks},
        {"name": "gru_fwd", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/gru_fwd.cu",
         "kernel": "gru_fwd_persistent_kernel",
         "replaces": "ctc_asr_tpu/ops/lstm_pallas.py:474",
         "launches": gl["gru_fwd"], "ladder_launches": ll["gru_fwd"],
         **k45["gru_fwd"]},
        {"name": "gru_bwd", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/gru_bwd.cu",
         "kernel": "gru_bwd_persistent_kernel",
         "replaces": "ctc_asr_tpu/ops/lstm_pallas.py:511",
         "launches": gl["gru_bwd"], "ladder_launches": ll["gru_bwd"],
         **k45["gru_bwd"],
         "db_err_vs_f64": k5_f64["kernel"],
         "plain_db_err_vs_f64": k5_f64["plain"]},
        {"name": "ctc_alpha", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/ctc.cu",
         "replaces": "ctc_asr_tpu/ops/ctc_pallas.py:97",
         "launches": tl["ctc_alpha"], "gru_launches": gl["ctc_alpha"],
         "tp_launches": tpl["ctc_alpha"], "sp_launches": spl["ctc_alpha"],
         "ladder_launches": ll["ctc_alpha"], **k67["ctc_alpha"]},
        {"name": "ctc_beta_grad", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/ctc.cu",
         "replaces": "ctc_asr_tpu/ops/ctc_pallas.py:149",
         "launches": tl["ctc_beta_grad"],
         "gru_launches": gl["ctc_beta_grad"],
         "tp_launches": tpl["ctc_beta_grad"],
         "sp_launches": spl["ctc_beta_grad"],
         "ladder_launches": ll["ctc_beta_grad"], **k67["ctc_beta_grad"]},
        {"name": "beam_search", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/beam.cu",
         "replaces": "ctc_asr_tpu/ops/beam_pallas.py:107",
         "launches": dl["beam"], "ladder_launches": ll["beam"], **k8},
    ]
    # the OOV and synth runners' and the repro pairs' launches, by the
    # counters' names (the LSTM pair's, for K4 / K5 the GRU pair's)
    for row in kernels:
        key = {"stft_mel": "stft", "beam_search": "beam"}.get(row["name"],
                                                              row["name"])
        row["oov_launches"], row["synth_launches"] = ool[key], syl[key]
        if key != "beam":
            pair = rep["launches"]["gru" if key.startswith("gru")
                                   else "lstm"]
            row["repro_launches"] = pair[key]
    kernels.append({"name": "rel_attention", "route": "cuda",
                    "source": "ctc_asr_tpu_torch/csrc/rel_attention.cu",
                    "replaces": None, **k9})
    log(f"[repro] B=128 x 8 s step ms (median, deterministic by default): "
        f"LSTM {rep['step_ms']['lstm']:.2f}, GRU {rep['step_ms']['gru']:.2f}")
    log(f"[step] train step ms at B=128 x 8 s: LSTM kernel path "
        f"{step['kernel_ms']:.1f}, plain path {step['plain_ms']:.1f}; GRU "
        f"kernel path {gru_step['kernel_ms']:.1f}, plain path "
        f"{gru_step['plain_ms']:.1f}")
    for tag, st in (("LSTM", step), ("GRU", gru_step)):
        log(f"[step] {tag} step, default conv against "
            f"--model.conv_as_matmul=false (host clock, in turns): "
            f"{st['default_ms']} against {st['conv2d_ms']} ms; frontend "
            f"group (profiler) {st['frontend_ms']:.2f} against "
            f"{st['frontend_conv2d_ms']:.2f} ms a step")
    log("[conv] summary, device ms (fwd, fwd + bwd): " + json.dumps(
        {shape: {name: [e[t]["device_ms"] for t in ("fwd", "fwd_bwd")
                        if t in e] for name, e in forms.items()}
         for shape, forms in conv.items()}))
    log(f"[time] all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--strict-worker"]:
        sys.exit(strict_worker(sys.argv[2:]))
    sys.exit(main())
