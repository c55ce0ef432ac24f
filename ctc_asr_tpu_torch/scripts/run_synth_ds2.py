"""Round-1 ladder rung 2 on the synthetic corpus: conv frontend + 3 x
BiLSTM-256, trained on 128 utterances (seed 1), then decoded greedy and
beam 16 on the same utterances. Counterpart of
``scripts/run_synth_ds2.py``; prints one JSON line with its keys.

    python -m ctc_asr_tpu_torch.scripts.run_synth_ds2 [--steps 600] \\
        [--n 128] --out DS2

Runs on ``--device`` (``cuda`` by default, where every kernel of the
path runs); without a GPU it raises unless ``--device cpu`` is given.
``run_synth_lm`` decodes the checkpoint it leaves under ``<out>/train``.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="run_synth_ds2")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--out", required=True,
                    help="work directory: corpus, checkpoint")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def synth_cfg(args, manifest_path: str):
    from ..config import (Config, DataConfig, DecodeConfig, FeatureConfig,
                          ModelConfig, TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=ModelConfig(frontend="conv", rnn_layers=3, rnn_units=256,
                          bidirectional=True, dropout=0.0),
        data=DataConfig(train_manifest=manifest_path,
                        eval_manifest=manifest_path,
                        batch_size=16, num_buckets=2, num_workers=4,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=1e-3, total_steps=args.steps,
                          log_every=100, eval_every=10 ** 9,
                          checkpoint_every=args.steps,
                          train_dir=os.path.join(args.out, "train")),
        decode=DecodeConfig(method="greedy"),
    )


def main(argv=None) -> dict:
    """Train, decode; returns the JSON line's fields."""
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
                                        seed=1, min_words=2, max_words=5)
    cfg = synth_cfg(args, manifest_path)
    t0 = time.time()
    state = train(cfg, device=device)
    wall = time.time() - t0
    params = trained_params(state)
    res = {"train_steps": int(state["step"]),
           "train_wall_s": round(wall, 1)}
    for tag, dec in [("greedy", DecodeConfig(method="greedy")),
                     ("beam_pallas", DecodeConfig(method="beam",
                                                  beam_width=16,
                                                  use_pallas=True))]:
        r = eval_split(dc.replace(cfg, decode=dec), params, manifest_path,
                       device, log_samples=0)
        res[f"{tag}_wer"] = round(r["wer"], 4)
        res[f"{tag}_rtf"] = round(r["rtf"], 5)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
