"""Time the train step (``train.make_step_fn``) on the card at three
shapes, the step that ``cli train`` and the ladder's runners take:

- ``lstm_b128``: ``conv_bilstm3`` at ``bench.py``'s B=128 x 8 s, U=96;
- ``gru_b128``: the same with ``--model.rnn_type=gru``;
- ``ds3_b32``: ``deepspeech_beam`` (5 x BiLSTM-800) at the ladder's
  B=32 x 7.36 s, U=72, dropout 0.1 (``run_ladder_hard.rung_cfg``).

Each cell: one state from the preset's seed, seeded samples and labels
on the card, three steps to warm, then ``--steps`` steps each timed on
the host clock between two synchronizations, at torch's default
precision settings, as ``cli train`` runs. Prints one JSON line with
each cell's median, min and max ms, the card's name and power limit and
the torch and CUDA versions.

    python -m ctc_asr_tpu_torch.scripts.step_cost --steps 20

It uses only ``config.preset``, ``train.init_train_state`` and
``train.make_step_fn``, so that the same file times an older checkout
of the port when copied into it.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import statistics
import subprocess
import time

import numpy as np

# name: (preset, rnn_type, dropout or None for the preset's, B, samples, U)
CELLS = {"lstm_b128": ("conv_bilstm3", "lstm", None, 128, 128000, 96),
         "gru_b128": ("conv_bilstm3", "gru", None, 128, 128000, 96),
         "ds3_b32": ("deepspeech_beam", "lstm", 0.1, 32, 117760, 72)}


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def time_cell(name: str, steps: int, device: str = "cuda") -> dict:
    import torch
    from ..config import preset
    from .. import train as train_mod
    preset_name, rnn_type, dropout, B, S, U = CELLS[name]
    cfg = preset(preset_name)
    model = dc.replace(cfg.model, rnn_type=rnn_type)
    if dropout is not None:
        model = dc.replace(model, dropout=dropout)
    cfg = dc.replace(cfg, model=model)
    rng = np.random.default_rng(11)
    batch = [torch.from_numpy(a).to(device) for a in (
        (rng.standard_normal((B, S)) * 0.1).astype(np.float32),
        rng.integers(S // 2, S + 1, B).astype(np.int32),
        rng.integers(0, 28, (B, U)).astype(np.int32),
        rng.integers(U // 2, U + 1, B).astype(np.int32))]
    batch[1][0] = S
    state = train_mod.init_train_state(cfg, device)
    step = train_mod.make_step_fn(cfg)
    for _ in range(3):
        step(state, *batch)
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "steps": steps}


def main(argv=None) -> dict:
    import torch
    ap = argparse.ArgumentParser(prog="step_cost")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_cost times the card: CUDA is not available")
    out = {"cells": {c: time_cell(c, args.steps)
                     for c in args.cells.split(",")},
           "device": torch.cuda.get_device_name(0), "smi": _smi(),
           "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
