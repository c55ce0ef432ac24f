#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ctc_asr_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):

1. Device: name, compute capability, ``nvidia-smi`` name and power
   limit, torch / CUDA / nvcc versions. Needs CUDA with capability 9.0.
2. Build: compiles the CUDA kernels from ``ctc_asr_tpu_torch/csrc``.
3. Kernels versus their plain PyTorch versions, at the serving path's
   shapes: max abs error against a stated tolerance, and the median of
   CUDA-event times over repeated runs after warm-up.
4. Slice: a seeded random checkpoint at full ``conv_bilstm3`` width in
   the reference's keypath format, a synthetic corpus, then the port's
   ``cli evaluate`` and ``cli transcribe`` on ``cuda``. The kernels'
   launch counters must rise during that run. Every eval batch then
   goes through the kernel path and the plain path: finite logits of
   the expected shape and lengths, and a per-frame argmax that agrees
   on at least 99.5% of the valid frames.
5. Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and
   last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
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


def phase_stft() -> dict:
    import torch
    from ctc_asr_tpu.config import FeatureConfig, preset
    from ctc_asr_tpu_torch.ops import stft_cuda
    res = {"max_abs_err": 0.0}
    cases = [("mel B=128 x 8 s", preset("conv_bilstm3").features, 128, 128000),
             ("mfcc B=4 x 1.5 s", FeatureConfig(feature_type="mfcc",
                                                n_mfcc=13, n_mels=40), 4, 24000)]
    for i, (label, cfg, B, S) in enumerate(cases):
        x = _speechlike(B, S, seed=B)
        got = stft_cuda.stft_features(x, cfg)
        want = stft_cuda.stft_features_plain(x, cfg)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: stft_cuda.stft_features(x, cfg), reps=20)
        plain_ms = cuda_ms(lambda: stft_cuda.stft_features_plain(x, cfg),
                           reps=20)
        log(f"[K1 stft] {label}: out {tuple(got.shape)} max_abs_err={err:.3e}"
            f" (tol {STFT_TOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not torch.isfinite(got).all() or not err <= STFT_TOL:
            raise AssertionError(f"K1 {label}: max_abs_err {err} > {STFT_TOL}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if i == 0:   # the serving path's shape gives the reported times
            res.update(ms=ms, plain_ms=plain_ms)
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


def phase_lstm() -> dict:
    import torch
    from ctc_asr_tpu_torch.ops import lstm_cuda
    rng = np.random.default_rng(1)
    res = {"max_abs_err": 0.0}
    cases = [
        ("bi nd=2 B=128 T=399 H=512", 2, 399, 128, 512,
         np.concatenate([[399], rng.integers(200, 400, 127)])),
        ("uni nd=1 B=37 T=50 H=512 ragged", 1, 50, 37, 512,
         np.concatenate([[50, 1, 2], rng.integers(1, 51, 34)])),
    ]
    for i, (label, nd, T, B, H, lens) in enumerate(cases):
        args = _lstm_inputs(nd, T, B, H, lens, seed=nd)
        got = lstm_cuda.lstm_seq(*args)
        want = lstm_cuda.lstm_seq_plain(*args).to(torch.bfloat16)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # outputs past each row's window must be exactly zero
        t = torch.arange(T, device=got.device)[None, :, None]
        outside = (t < args[3][:, None, :]) | (t >= args[4][:, None, :])
        zero_ok = bool((got.float().abs().amax(-1)[outside] == 0).all())
        ms = cuda_ms(lambda: lstm_cuda.lstm_seq(*args), reps=10)
        plain_ms = cuda_ms(lambda: lstm_cuda.lstm_seq_plain(*args), reps=3,
                           warmup=1)
        log(f"[K2 lstm] {label}: max_abs_err={err:.3e} mean_abs_err="
            f"{diff.mean().item():.3e} (tol {LSTM_TOL}) zero_outside="
            f"{zero_ok} kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not err <= LSTM_TOL or not zero_ok:
            raise AssertionError(f"K2 {label}: err {err} zero_ok {zero_ok}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if i == 0:
            res.update(ms=ms, plain_ms=plain_ms)
    return res


def random_checkpoint(cfg, path: str, seed: int = 0) -> None:
    """Glorot-uniform weights, zero biases with LSTM forget bias 1, in
    the reference checkpoint's keypath format."""
    from ctc_asr_tpu_torch.models import init_shapes
    rng = np.random.default_rng(seed)
    flat = {}
    H = cfg.model.rnn_units
    for k, shape in init_shapes(cfg.model, cfg.features.feature_dim).items():
        if k.endswith("/b"):
            v = np.zeros(shape, np.float32)
            if k.startswith("rnn/"):
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


def phase_slice(tmp: str) -> dict:
    import torch
    from ctc_asr_tpu.config import apply_overrides, preset
    from ctc_asr_tpu.data import DataLoader, read_manifest
    from ctc_asr_tpu.data.synth import generate_corpus
    from ctc_asr_tpu_torch.checkpoint import load_params
    from ctc_asr_tpu_torch.evaluate import make_eval_step
    from ctc_asr_tpu_torch.features import frame_lengths_from_sample_lengths
    from ctc_asr_tpu_torch.models import output_lengths
    from ctc_asr_tpu_torch.ops import lstm_cuda, stft_cuda
    from ctc_asr_tpu_torch.ops.greedy import greedy_decode

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
    lstm_cuda.lstm_seq.launches = 0
    ev = run_cli(["evaluate", "--preset", "conv_bilstm3", "--ckpt", ckpt,
                  "--device=cuda"]
                 + [f"--{k}={v}" for k, v in overrides.items()])
    tr = run_cli(["transcribe", "--preset", "conv_bilstm3", "--ckpt", ckpt,
                  "--device=cuda", *wavs])
    launches = {"stft": stft_cuda.stft_features.launches,
                "lstm": lstm_cuda.lstm_seq.launches}
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

    # every eval batch through the kernel path and the plain path; the
    # argmax agreement pools all valid frames (random weights give
    # logits of std ~0.05, so a few percent of frames have top-2
    # margins under 1e-3, where bf16 rounding decides the argmax)
    params = load_params(ckpt, cfg, "cuda")
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
    log(f"[slice] kernel vs plain path over {n_utts} utterances / "
        f"{n_frames} frames: max logit err={err:.3e} argmax agreement="
        f"{agree:.6f} identical transcripts={same}/{n_utts}")
    if agree < ARGMAX_AGREEMENT:
        raise AssertionError(f"argmax agreement {agree} < {ARGMAX_AGREEMENT}")
    return {"launches": launches, "rtf": res["rtf"]}


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

    dev = phase_device()
    phase_build()
    k1 = phase_stft()
    k2 = phase_lstm()
    with tempfile.TemporaryDirectory() as tmp:
        sl = phase_slice(tmp)
    kernels = [
        {"name": "stft_mel", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/stft.cu",
         "replaces": "ctc_asr_tpu/ops/stft_pallas.py:102",
         "launches": sl["launches"]["stft"], **k1},
        {"name": "lstm_fwd", "route": "cuda",
         "source": "ctc_asr_tpu_torch/csrc/lstm_fwd.cu",
         "replaces": "ctc_asr_tpu/ops/lstm_pallas.py:199",
         "launches": sl["launches"]["lstm"], **k2},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
