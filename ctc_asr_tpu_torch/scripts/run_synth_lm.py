"""Round-1 ladder rung 4 on the synthetic corpus: beam search, + char-LM
shallow fusion, + word-LM N-best rescoring, on the checkpoint that
``run_synth_ds2`` leaves. The order-3 char LM and the word bigram are
trained on the corpus's transcripts. Counterpart of
``scripts/run_synth_lm.py``; prints one JSON line with its keys.

    python -m ctc_asr_tpu_torch.scripts.run_synth_lm --dir DS2

Runs on ``--device`` (``cuda`` by default); without a GPU it raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="run_synth_lm")
    ap.add_argument("--dir", required=True,
                    help="the --out of run_synth_ds2")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def synth_cfg(args, manifest_path: str):
    """The ds2 rung's geometry, for evaluation only."""
    from ..config import (Config, DataConfig, FeatureConfig, ModelConfig,
                          TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mel", n_mels=80),
        model=ModelConfig(frontend="conv", rnn_layers=3, rnn_units=256,
                          bidirectional=True, dropout=0.0),
        data=DataConfig(eval_manifest=manifest_path, batch_size=16,
                        num_buckets=2, num_workers=4,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(train_dir=os.path.join(args.dir, "train")),
    )


def main(argv=None) -> dict:
    """Train the LMs, decode three ways; returns the JSON line's fields."""
    args = parse_args(argv)
    from .. import checkpoint
    from ..config import DecodeConfig
    from ..data import read_manifest
    from ..ops import lm as lm_mod
    from ..ops.dispatch import resolve_device
    from .run_ladder_hard import eval_split
    device = str(resolve_device(args.device))   # raises without a GPU
    manifest_path = os.path.join(args.dir, "corpus", "manifest.csv")
    texts = [u.transcript for u in read_manifest(manifest_path)]

    char_lm_path = os.path.join(args.dir, "char_lm.npz")
    word_lm_path = os.path.join(args.dir, "word_lm.pkl")
    lm_mod.save_lm(char_lm_path, lm_mod.train_char_lm(texts, order=3))
    lm_mod.save_word_lm(word_lm_path, lm_mod.train_word_lm(texts, order=2))

    base = synth_cfg(args, manifest_path)
    params = checkpoint.load_params(base.train.train_dir, base,
                                    device=device)
    res = {}
    for tag, dec in [
        ("beam", DecodeConfig(method="beam", beam_width=16)),
        ("beam_charlm", DecodeConfig(method="beam", beam_width=16,
                                     lm_path=char_lm_path, lm_weight=0.6,
                                     word_bonus=0.5)),
        ("beam_rescored", DecodeConfig(method="beam", beam_width=16,
                                       lm_path=char_lm_path,
                                       lm_weight=0.6, word_bonus=0.5,
                                       word_lm_path=word_lm_path,
                                       rescore_alpha=0.8, nbest=8)),
    ]:
        r = eval_split(dc.replace(base, decode=dec), params, manifest_path,
                       device, log_samples=0)
        res[f"{tag}_wer"] = round(r["wer"], 4)
        res[f"{tag}_cer"] = round(r["cer"], 4)
        res[f"{tag}_rtf"] = round(r["rtf"], 5)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
