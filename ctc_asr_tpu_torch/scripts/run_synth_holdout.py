"""Held-out evaluation on the synthetic corpus: train and evaluate on
DISJOINT utterances (a strided 4:1 split of 320, seed 7), so the model
must transcribe word sequences it never saw. Conv + 3 x BiLSTM-512,
dropout 0.05, 1200 steps, beam 16. Counterpart of
``scripts/run_synth_holdout.py``; prints one JSON line with its keys.

    python -m ctc_asr_tpu_torch.scripts.run_synth_holdout [--steps 1200] \\
        [--n-train 256] [--n-eval 64] [--specaugment] \\
        --out HOLDOUT

Runs on ``--device`` (``cuda`` by default); without a GPU it raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="run_synth_holdout")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--n-eval", type=int, default=64)
    ap.add_argument("--out", required=True,
                    help="work directory: corpus, checkpoint")
    ap.add_argument("--specaugment", action="store_true",
                    help="train with SpecAugment")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def split_manifest(manifest_path: str) -> tuple:
    """Every fifth line to ``eval.csv``, the rest to ``train.csv`` (strided,
    so the two have the same durations); returns (train, eval, number of
    train lines)."""
    corpus = os.path.dirname(manifest_path)
    with open(manifest_path) as f:
        lines = f.read().strip().split("\n")
    train_lines = [ln for i, ln in enumerate(lines) if i % 5 != 4]
    eval_lines = [ln for i, ln in enumerate(lines) if i % 5 == 4]
    train_manifest = os.path.join(corpus, "train.csv")
    eval_manifest = os.path.join(corpus, "eval.csv")
    for path, part in ((train_manifest, train_lines),
                       (eval_manifest, eval_lines)):
        with open(path, "w") as f:
            f.write("\n".join(part) + "\n")
    return train_manifest, eval_manifest, len(train_lines)


def synth_cfg(args, train_manifest: str, eval_manifest: str):
    from ..config import (Config, DataConfig, DecodeConfig, FeatureConfig,
                          ModelConfig, TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=ModelConfig(frontend="conv", rnn_layers=3, rnn_units=512,
                          bidirectional=True, dropout=0.05),
        data=DataConfig(train_manifest=train_manifest,
                        eval_manifest=eval_manifest,
                        batch_size=16, num_buckets=1,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=5e-4, total_steps=args.steps,
                          log_every=100, eval_every=0,
                          checkpoint_every=args.steps,
                          specaugment=args.specaugment,
                          train_dir=os.path.join(args.out, "train")),
        decode=DecodeConfig(method="beam", beam_width=16),
    )


def main(argv=None) -> dict:
    """Train on the 4 parts, decode the fifth; returns the JSON line's
    fields."""
    args = parse_args(argv)
    from ..data.synth import generate_corpus
    from ..ops.dispatch import resolve_device
    from ..train import train
    from .run_ladder_hard import eval_split, trained_params
    device = str(resolve_device(args.device))   # raises without a GPU
    corpus = os.path.join(args.out, "corpus")
    manifest_path = os.path.join(corpus, "manifest.csv")
    if not os.path.exists(manifest_path):
        manifest_path = generate_corpus(
            corpus, num_utterances=args.n_train + args.n_eval, seed=7,
            min_words=2, max_words=6)
    train_manifest, eval_manifest, n_train = split_manifest(manifest_path)
    cfg = synth_cfg(args, train_manifest, eval_manifest)
    t0 = time.time()
    state = train(cfg, device=device)
    wall = time.time() - t0
    r = eval_split(cfg, trained_params(state), eval_manifest, device,
                   log_samples=3)
    res = {"train_steps": int(state["step"]),
           "train_wall_s": round(wall, 1),
           "train_utts": n_train,
           "heldout_utts": r["utterances"],
           "heldout_wer": round(r["wer"], 4),
           "heldout_cer": round(r["cer"], 4),
           "beam_rtf": round(r["rtf"], 5),
           "specaugment": args.specaugment}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
