"""Round-1 ladder rung 3 on the synthetic corpus: the DeepSpeech-style
model (conv + 5 x BiLSTM-800) trained on 96 utterances (seed 2), then
decoded by the beam kernel at beam 64 on the same utterances.
Counterpart of ``scripts/run_synth_ds3.py``; prints one JSON line with
its keys.

    python -m ctc_asr_tpu_torch.scripts.run_synth_ds3 [--steps 300] \\
        [--seed 42] --out DS3

Runs on ``--device`` (``cuda`` by default); without a GPU it raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="run_synth_ds3")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", required=True,
                    help="work directory: corpus, checkpoint")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--seed", type=int, default=42,
                    help="train.seed: the init's and the dropout's draws")
    return ap.parse_args(argv)


def synth_cfg(args, manifest_path: str):
    from ..config import (Config, DataConfig, DecodeConfig, FeatureConfig,
                          ModelConfig, TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=ModelConfig(frontend="conv", rnn_layers=5, rnn_units=800,
                          bidirectional=True, dropout=0.0),
        data=DataConfig(train_manifest=manifest_path,
                        eval_manifest=manifest_path,
                        batch_size=8, num_buckets=1, num_workers=4,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=5e-4, total_steps=args.steps,
                          log_every=50, eval_every=10 ** 9,
                          checkpoint_every=args.steps, seed=args.seed,
                          train_dir=os.path.join(args.out, "train")),
        decode=DecodeConfig(method="beam", beam_width=64, use_pallas=True),
    )


def main(argv=None) -> dict:
    """Train, decode; returns the JSON line's fields."""
    args = parse_args(argv)
    from ..data.synth import generate_corpus
    from ..ops.dispatch import resolve_device
    from ..train import train
    from .run_ladder_hard import eval_split, trained_params
    device = str(resolve_device(args.device))   # raises without a GPU
    corpus_dir = os.path.join(args.out, "corpus")
    manifest_path = os.path.join(corpus_dir, "manifest.csv")
    if not os.path.exists(manifest_path):
        manifest_path = generate_corpus(corpus_dir, num_utterances=96,
                                        seed=2, min_words=2, max_words=5)
    cfg = synth_cfg(args, manifest_path)
    t0 = time.time()
    state = train(cfg, device=device)
    wall = time.time() - t0
    r = eval_split(cfg, trained_params(state), manifest_path, device,
                   log_samples=0)
    res = {"train_steps": int(state["step"]),
           "train_wall_s": round(wall, 1),
           "beam64_pallas_wer": round(r["wer"], 4),
           "beam64_rtf": round(r["rtf"], 5)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
