"""Round-1 end-to-end run on the synthetic corpus: MFCC-26 + dense 2 x
256 + 2 x uni-LSTM-256, trained on 96 utterances (seed 0), then decoded
three ways on the same utterances: greedy, the plain beam search at beam
16 (``use_pallas=False``, on the same device) and the beam kernel at
beam 16. Once trained, the three give the same WER. Counterpart of
``scripts/run_synth_e2e.py``; prints one JSON line with its keys.

    python -m ctc_asr_tpu_torch.scripts.run_synth_e2e [--steps 500] \\
        [--n 96] [--batch 8] --out E2E

Runs on ``--device`` (``cuda`` by default); without a GPU it raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="run_synth_e2e")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--out", required=True,
                    help="work directory: corpus, checkpoint")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def synth_cfg(args, manifest_path: str):
    from ..config import (Config, DataConfig, DecodeConfig, FeatureConfig,
                          ModelConfig, TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=26, n_mels=40),
        model=ModelConfig(frontend="dense", dense_layers=2,
                          dense_units=256, rnn_layers=2, rnn_units=256,
                          bidirectional=False, dropout=0.0),
        data=DataConfig(train_manifest=manifest_path,
                        eval_manifest=manifest_path,
                        batch_size=args.batch, num_buckets=2,
                        num_workers=4, min_audio_seconds=0.05,
                        max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=2e-3, total_steps=args.steps,
                          log_every=50, eval_every=10 ** 9,
                          checkpoint_every=args.steps,
                          train_dir=os.path.join(args.out, "train")),
        decode=DecodeConfig(method="greedy"),
    )


def main(argv=None) -> dict:
    """Train, decode three ways; returns the JSON line's fields."""
    args = parse_args(argv)
    from ..config import DecodeConfig
    from ..data.synth import generate_corpus
    from ..ops.dispatch import resolve_device
    from ..train import train
    from .run_ladder_hard import eval_split, trained_params
    device = str(resolve_device(args.device))   # raises without a GPU
    corpus_dir = os.path.join(args.out, "corpus")
    manifest_path = os.path.join(corpus_dir, "manifest.csv")
    if not os.path.exists(manifest_path):
        manifest_path = generate_corpus(corpus_dir, num_utterances=args.n,
                                        seed=0, min_words=1, max_words=3)
    cfg = synth_cfg(args, manifest_path)
    t0 = time.time()
    state = train(cfg, device=device)
    train_wall = time.time() - t0
    params = trained_params(state)
    res = {"train_steps": int(state["step"]),
           "train_wall_s": round(train_wall, 1)}
    # beam_xla is the plain beam search, beam_pallas the beam kernel
    for tag, dec in [("greedy", DecodeConfig(method="greedy")),
                     ("beam_xla", DecodeConfig(method="beam", beam_width=16,
                                               use_pallas=False)),
                     ("beam_pallas", DecodeConfig(method="beam",
                                                  beam_width=16,
                                                  use_pallas=True))]:
        r = eval_split(dc.replace(cfg, decode=dec), params, manifest_path,
                       device, log_samples=1)
        res[f"{tag}_wer"] = round(r["wer"], 4)
        res[f"{tag}_cer"] = round(r["cer"], 4)
        res[f"{tag}_rtf"] = round(r["rtf"], 5)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
