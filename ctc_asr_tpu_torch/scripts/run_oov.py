"""The open-vocabulary (OOV) rung and the n=4096 settler.

Counterpart of ``scripts/run_oov.py``. It reuses the artifacts of an
"r4big" ladder run (a 4096 / 256 / 1024 hard corpus, the 8000-step
ds2+SA and ds3+SA checkpoints, the train-text LMs), made by

    python -m ctc_asr_tpu_torch.scripts.run_ladder_hard --out R4BIG \\
        --n-train 4096 --n-dev 256 --n-test 1024 --steps-scale 2 \\
        --rungs ds2sa,ds3sa
    python -m ctc_asr_tpu_torch.scripts.continue_rung --out R4BIG \\
        --rung ds2_specaug --steps 8000
    python -m ctc_asr_tpu_torch.scripts.continue_rung --out R4BIG \\
        --rung ds3sa --steps 8000 --chain

and trains nothing. Two measurements:

1. **Settler**: a fresh n=4096 in-vocabulary test split (seed-7
   vocabulary, held-out speakers 1000.., SNR 5-20 dB, transcripts
   disjoint from every r4big split), decoded by both arms; the ds3 chain
   reuses the 8000-step DEV-selected fusion weight (w=0.4).
2. **OOV rung**: dev / test splits whose transcripts draw from a
   disjoint 384-word inventory (``data.synth.build_oov_vocabulary``), so
   every WER measures unseen-word generalization. The ds3+SA arm decodes
   greedy, beam 64, + char-LM fusion and + word-LM rescoring under two
   LM text conditions: LMs of the acoustic-train transcripts (no OOV
   word) and LMs of 16384 sentences over base + OOV vocabulary. Fusion
   weights and rescore alphas are selected on the OOV DEV split and
   reported on the OOV TEST split; ds2+SA decodes greedy as a control.

The records (``oov_results.jsonl``), their ``compare`` labels and the
per-utterance sidecars (``per_utt/<tag>.json``) are the reference's,
name for name, so that each pairs with its TPU record (``cli compare``).

    python -m ctc_asr_tpu_torch.scripts.run_oov --r4big R4BIG --out OUT \\
        [--archive DIR]

Runs on ``--device`` (``cuda`` by default); without a GPU it raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import shutil
import time

from . import run_ladder_hard as lh

CORPUS_SEED = 7          # the r4big corpus seed (run_ladder_hard)
FUSION_WEIGHTS = (0.0, 0.2, 0.4, 0.6)
SETTLER_LM_WEIGHT = 0.4  # the r4 8000-step DEV-selected fusion weight
BEAM_WIDTH = 64          # the records' "beam64"


def arm_cfg(preset_name: str, eval_manifest: str, batch: int = 32):
    """The preset with the r4big ladder's eval data settings and dropout."""
    from ..config import preset
    cfg = preset(preset_name)
    return dc.replace(
        cfg,
        data=dc.replace(cfg.data, eval_manifest=eval_manifest,
                        batch_size=batch, num_buckets=2,
                        min_audio_seconds=0.3, max_audio_seconds=12.0),
        model=dc.replace(cfg.model, dropout=0.1))


def with_decode(cfg, **kw):
    return dc.replace(cfg, decode=dc.replace(cfg.decode, **kw))


def r4big_transcripts(r4big: str) -> set:
    """Every transcript of the r4big train / dev / test splits."""
    from ..data import read_manifest
    exclude = set()
    for split in ("train", "dev", "test"):
        p = os.path.join(r4big, "corpus", f"{split}.csv")
        exclude.update(u.transcript for u in read_manifest(p))
    return exclude


def make_splits(out: str, exclude: set, n_bigtest: int, n_oov_dev: int,
                n_oov_test: int) -> dict:
    """The settler's ``bigtest`` and the OOV ``oov_dev`` / ``oov_test``
    manifests under ``out`` (each generated once); returns their paths
    and the two vocabularies."""
    from ..data.synth import (build_oov_vocabulary, build_vocabulary,
                              generate_hard_split)
    base_vocab = build_vocabulary(384, seed=CORPUS_SEED + 1234)
    oov_vocab = build_oov_vocabulary(384, 384, seed=CORPUS_SEED + 1234)

    def gen(split, vocab, n, seed, spk_base, n_speakers, split_id):
        path = os.path.join(out, f"{split}.csv")
        if os.path.exists(path):
            return path
        t0 = time.time()
        p = generate_hard_split(out, split, vocab, n, seed=seed,
                                spk_base=spk_base, n_speakers=n_speakers,
                                split_id=split_id,
                                exclude_transcripts=exclude)
        print(f"[oov] {split}: {n} utts in {time.time()-t0:.1f}s",
              flush=True)
        return p

    return {"bigtest": gen("bigtest", base_vocab, n_bigtest, seed=7001,
                           spk_base=1000, n_speakers=12, split_id=10),
            "oov_dev": gen("oov_dev", oov_vocab, n_oov_dev, seed=7002,
                           spk_base=0, n_speakers=32, split_id=11),
            "oov_test": gen("oov_test", oov_vocab, n_oov_test, seed=7003,
                            spk_base=1000, n_speakers=12, split_id=12),
            "base_vocab": base_vocab, "oov_vocab": oov_vocab}


def full_text_lms(out: str, vocab: tuple, n_sentences: int) -> tuple:
    """Order-4 char LM and word bigram of ``n_sentences`` generated over
    ``vocab`` (base + OOV), trained once; returns their paths."""
    from ..data.synth import generate_lm_text
    from ..ops import lm as lm_mod
    char_path = os.path.join(out, "charlm_full.npz")
    word_path = os.path.join(out, "wordlm_full.pkl")
    if not os.path.exists(char_path):
        texts = generate_lm_text(vocab, n_sentences, seed=7004)
        lm_mod.save_lm(char_path, lm_mod.train_char_lm(texts, order=4))
        lm_mod.save_word_lm(word_path, lm_mod.train_word_lm(texts, order=2))
        print("[oov] full-text LMs trained", flush=True)
    return char_path, word_path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="run_oov")
    ap.add_argument("--r4big", required=True,
                    help="the r4big run_ladder_hard --out")
    ap.add_argument("--out", required=True,
                    help="work directory: splits, LMs, records")
    ap.add_argument("--archive", default="")
    ap.add_argument("--n-bigtest", type=int, default=4096)
    ap.add_argument("--n-oov-dev", type=int, default=256)
    ap.add_argument("--n-oov-test", type=int, default=1024)
    ap.add_argument("--lm-sentences", type=int, default=16384)
    ap.add_argument("--skip-settler", action="store_true")
    ap.add_argument("--skip-oov", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the settler and the OOV rung; returns the records."""
    args = parse_args(argv)
    from .. import checkpoint
    from ..metrics import paired_bootstrap
    from ..ops.dispatch import resolve_device
    device = str(resolve_device(args.device))   # raises without a GPU
    os.makedirs(args.out, exist_ok=True)

    results_path = os.path.join(args.out, "oov_results.jsonl")
    utt_dir = os.path.join(args.out, "per_utt")
    os.makedirs(utt_dir, exist_ok=True)
    sidecars, records = {}, []

    def eval_split(cfg, params, manifest_path, log_samples=0):
        return lh.eval_split(cfg, params, manifest_path, device, log_samples)

    def emit(rec):
        records.append(rec)
        lh.append_record(results_path, rec, "oov")

    def record(tag, r):
        sidecars[tag] = r["per_utt"]
        with open(os.path.join(utt_dir, tag + ".json"), "w") as f:
            json.dump({"tag": tag, "per_utt": r["per_utt"]}, f)
        return {"test_wer": round(r["wer"], 4),
                "test_cer": round(r["cer"], 4),
                "test_wer_ci95": [round(x, 4) for x in r["wer_ci95"]],
                "rtf": round(r["rtf"], 5)}

    def compare(tag_a, tag_b, label):
        out = paired_bootstrap(sidecars[tag_a], sidecars[tag_b])
        lo, hi = out["wer_delta_ci95"]
        verdict = "A better" if hi < 0 else \
            "B better" if lo > 0 else "tied"
        emit({"compare": label, "a": tag_a, "b": tag_b,
              "wer_delta": round(out["wer_delta"], 4),
              "ci95": [round(lo, 4), round(hi, 4)],
              "p_a_better": round(out["p_a_better"], 3),
              "verdict": verdict})

    # --- corpus: three splits disjoint from every r4big transcript ------
    exclude = r4big_transcripts(args.r4big)
    print(f"[oov] {len(exclude)} existing transcripts excluded", flush=True)
    sp = make_splits(args.out, exclude, args.n_bigtest, args.n_oov_dev,
                     args.n_oov_test)
    bigtest, oov_dev, oov_test = sp["bigtest"], sp["oov_dev"], sp["oov_test"]

    # --- LMs: the r4big train-text ones and the full-text ones ----------
    charlm_train = os.path.join(args.r4big, "charlm.npz")
    wordlm_train = os.path.join(args.r4big, "wordlm.pkl")
    charlm_full, wordlm_full = full_text_lms(
        args.out, sp["base_vocab"] + sp["oov_vocab"], args.lm_sentences)

    # --- checkpoints: the r4big arms at 8000 steps ----------------------
    ds2_ckpt = os.path.join(args.r4big, "train_ds2_specaug", "ckpt",
                            "step_00008000.npz")
    ds3_ckpt = os.path.join(args.r4big, "train_ds3sa", "ckpt",
                            "step_00008000.npz")
    cfg2 = arm_cfg("conv_bilstm3", bigtest)
    cfg3 = arm_cfg("deepspeech_beam", bigtest)
    params2 = checkpoint.load_params(ds2_ckpt, cfg2, device=device)
    params3 = checkpoint.load_params(ds3_ckpt, cfg3, device=device)
    g2 = with_decode(cfg2, method="greedy")

    # --- 1) settler: n=4096 in-vocabulary, both arms at 8000 steps ------
    if not args.skip_settler:
        r = eval_split(g2, params2, bigtest)
        emit({"arm": "ds2+SA@8000", "decode": "greedy",
              "split": "bigtest4096", **record("settler_ds2sa", r)})

        r = eval_split(with_decode(cfg3, method="greedy"), params3, bigtest)
        emit({"arm": "ds3+SA@8000", "decode": "greedy",
              "split": "bigtest4096", **record("settler_ds3sa_greedy", r)})

        r = eval_split(with_decode(cfg3, method="beam", beam_width=BEAM_WIDTH),
                       params3, bigtest)
        emit({"arm": "ds3+SA@8000", "decode": "beam64",
              "split": "bigtest4096", **record("settler_ds3sa_beam", r)})

        # the weight is reused, not re-tuned: the settler changes the
        # TEST set only
        r = eval_split(with_decode(cfg3, method="beam", beam_width=BEAM_WIDTH,
                                   lm_path=charlm_train,
                                   lm_weight=SETTLER_LM_WEIGHT,
                                   word_bonus=0.5),
                       params3, bigtest)
        emit({"arm": "ds3+SA@8000", "decode": "beam64+charlm(w=0.4)",
              "split": "bigtest4096", **record("settler_ds3sa_chain", r)})

        compare("settler_ds3sa_chain", "settler_ds2sa",
                "SETTLER ds3-chain vs ds2+SA @8000, n=4096")
        compare("settler_ds3sa_beam", "settler_ds2sa",
                "ds3+SA beam vs ds2+SA greedy @8000, n=4096")
        compare("settler_ds3sa_chain", "settler_ds3sa_beam",
                "fusion delta @8000, n=4096")

    # --- 2) OOV rung ----------------------------------------------------
    if args.skip_oov:
        return records

    def oov_chain(name, cfg, params):
        gcfg = dc.replace(cfg,
                          data=dc.replace(cfg.data, eval_manifest=oov_test),
                          decode=dc.replace(cfg.decode, method="greedy"))
        r = eval_split(gcfg, params, oov_test, log_samples=2)
        emit({"arm": name, "decode": "greedy", "split": "oov_test",
              **record(f"oov_{name}_greedy", r)})

        bcfg = dc.replace(gcfg, decode=dc.replace(
            cfg.decode, method="beam", beam_width=BEAM_WIDTH))
        r = eval_split(bcfg, params, oov_test)
        emit({"arm": name, "decode": "beam64", "split": "oov_test",
              **record(f"oov_{name}_beam", r)})

        for lm_tag, char_path, word_path in (
                ("trainlm", charlm_train, wordlm_train),
                ("fulllm", charlm_full, wordlm_full)):
            # char-LM fusion, w selected on OOV DEV (w=0 in the grid: DEV
            # can decline fusion)
            tag = f"oov {name}/{lm_tag}"
            lcfg, best_w, best_dev = lh.select_lm_weight(
                bcfg, params, oov_dev, char_path, FUSION_WEIGHTS, device, tag)
            r = eval_split(lcfg, params, oov_test)
            emit({"arm": name,
                  "decode": f"beam64+charlm[{lm_tag}](w={best_w})",
                  "split": "oov_test", "dev_wer": round(best_dev, 4),
                  **record(f"oov_{name}_fusion_{lm_tag}", r)})

            # word-LM N-best rescoring on top (alpha=0 in the grid)
            acfg, best_a, best_dev_a = lh.select_rescore_alpha(
                lcfg, params, oov_dev, word_path, lh.RESCORE_ALPHAS, device,
                tag)
            r = eval_split(acfg, params, oov_test)
            emit({"arm": name,
                  "decode": f"beam64+charlm[{lm_tag}]"
                            f"+wordlm[{lm_tag}](a={best_a})",
                  "split": "oov_test", "dev_wer": round(best_dev_a, 4),
                  **record(f"oov_{name}_rescore_{lm_tag}", r)})

        compare(f"oov_{name}_fusion_trainlm", f"oov_{name}_beam",
                f"{name}: train-only char-LM fusion vs beam on OOV")
        compare(f"oov_{name}_fusion_fulllm", f"oov_{name}_beam",
                f"{name}: full-text char-LM fusion vs beam on OOV")
        compare(f"oov_{name}_rescore_fulllm", f"oov_{name}_fusion_fulllm",
                f"{name}: full-text word-LM rescore delta on OOV")
        compare(f"oov_{name}_rescore_trainlm", f"oov_{name}_fusion_trainlm",
                f"{name}: train-only word-LM rescore delta on OOV")

    oov_chain("ds3sa8000", cfg3, params3)
    # the ds2 control, greedy only: how much of the OOV gap does not
    # depend on the model
    r = eval_split(g2, params2, oov_test)
    emit({"arm": "ds2sa8000", "decode": "greedy", "split": "oov_test",
          **record("oov_ds2sa8000_greedy", r)})
    compare("oov_ds3sa8000_greedy", "oov_ds2sa8000_greedy",
            "ds3+SA vs ds2+SA greedy on OOV")

    if args.archive:
        os.makedirs(args.archive, exist_ok=True)
        shutil.copy(results_path, args.archive)
        dst = os.path.join(args.archive, "per_utt")
        os.makedirs(dst, exist_ok=True)
        for fn in os.listdir(utt_dir):
            shutil.copy(os.path.join(utt_dir, fn), dst)
        print(f"[oov] archived to {args.archive}", flush=True)
    return records


if __name__ == "__main__":
    main()
