"""The configuration ladder on the hard synthetic corpus.

Counterpart of ``scripts/run_ladder_hard.py``: the same corpus (seed 7,
speaker formant / speed perturbation, additive noise at an SNR drawn
from ``--snr-low..--snr-high``, tone babble, disjoint train / dev / test
splits, held-out test speakers), the same rungs, step budgets, learning
rates, dropout, buckets and selection protocol, and the same records
and per-utterance sidecars, so that each rung can be held against the
reference's record utterance by utterance (``cli compare``).

Rungs (``--rungs``): ``pr1`` (MFCC + 2 x uni-LSTM-256, greedy),
``ds2`` (conv + 3 x BiLSTM-512, greedy; with ``--specaug-ab`` a second
arm with SpecAugment), ``ds2sa`` (that arm alone), ``ds3`` and
``ds3sa`` (conv + 5 x BiLSTM-800, without and with SpecAugment, each
decoded greedy, beam 64, + char-LM fusion, + word-LM rescoring). The
fusion weight is selected on DEV over ``--lm-weights``, then the
rescore alpha on DEV over (0.0, 0.3, 0.6, 1.0, 2.0); both are reported
on TEST.

    python -m ctc_asr_tpu_torch.scripts.run_ladder_hard --out /tmp/ladder \\
        --n-train 2048 --n-dev 256 --n-test 512 --steps-scale 2 \\
        --rungs ds2 --specaug-ab --archive ctc_asr_tpu_torch/results/x

Runs on ``--device`` (``cuda`` by default, where every rung goes
through the kernels); without a GPU it raises unless ``--device cpu``
is given. Every record is appended to ``<out>/ladder_results.jsonl``;
``--archive`` copies that file, the sidecars and the loss curves into
an archive directory. Groups of rungs run one after another (separate
processes) with one ``--out`` therefore build one archive, and share
the corpus and the LMs.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import shutil
import time

RESCORE_ALPHAS = (0.0, 0.3, 0.6, 1.0, 2.0)
LOG_EVERY = 200          # steps between the loss curves' records


def get_corpus(out: str, args) -> dict:
    """The hard corpus under ``out/corpus`` (generated once, seed 7);
    returns the three manifests' paths."""
    from ..data.synth import generate_hard_corpus
    corpus = os.path.join(out, "corpus")
    if not os.path.exists(os.path.join(corpus, "test.csv")):
        t0 = time.time()
        generate_hard_corpus(corpus, n_train=args.n_train,
                             n_dev=args.n_dev, n_test=args.n_test,
                             seed=7, snr_db=(args.snr_low, args.snr_high))
        print(f"[ladder] corpus generated in {time.time()-t0:.1f}s",
              flush=True)
    return {k: os.path.join(corpus, f"{k}.csv")
            for k in ("train", "dev", "test")}


def train_lms(out: str, train_manifest: str) -> tuple[str, str]:
    """Char 4-gram (fusion) and word bigram (rescoring) from TRAIN text."""
    from ..data import read_manifest
    from ..ops import lm as lm_mod
    char_path = os.path.join(out, "charlm.npz")
    word_path = os.path.join(out, "wordlm.pkl")
    if not (os.path.exists(char_path) and os.path.exists(word_path)):
        texts = [u.transcript for u in read_manifest(train_manifest)]
        lm_mod.save_lm(char_path, lm_mod.train_char_lm(texts, order=4))
        lm_mod.save_word_lm(word_path, lm_mod.train_word_lm(texts, order=2))
        print("[ladder] LMs trained", flush=True)
    return char_path, word_path


def rung_cfg(preset_name: str, man: dict, out: str, rung: str, steps: int,
             batch: int, lr: float, wire: str = "int16", fcache: str = "",
             seed: int | None = None):
    """The preset with the ladder's data, dropout and train settings
    (``seed``: the train seed, if not the preset's)."""
    from ..config import preset
    cfg = preset(preset_name)
    if seed is not None:
        cfg = dc.replace(cfg, train=dc.replace(cfg.train, seed=seed))
    return dc.replace(
        cfg,
        data=dc.replace(cfg.data, train_manifest=man["train"],
                        eval_manifest=man["test"], batch_size=batch,
                        num_buckets=2, min_audio_seconds=0.3,
                        max_audio_seconds=12.0, wire_dtype=wire,
                        feature_cache=fcache),
        model=dc.replace(cfg.model, dropout=0.1),
        train=dc.replace(cfg.train, learning_rate=lr, total_steps=steps,
                         log_every=LOG_EVERY, eval_every=0,
                         checkpoint_every=steps,
                         train_dir=os.path.join(out, f"train_{rung}")))


def eval_split(cfg, params: dict, manifest_path: str, device: str,
               log_samples: int = 2, on_batch=None) -> dict:
    """``evaluate`` over one split, every utterance in the loader's order
    (``on_batch`` as ``evaluate`` takes it)."""
    from ..data import DataLoader, read_manifest
    from ..evaluate import evaluate
    loader = DataLoader(read_manifest(manifest_path), cfg.data,
                        cfg.features, drop_last=False)
    return evaluate(cfg, params, device=device, loader=loader,
                    log_samples=log_samples, on_batch=on_batch)


def trained_params(state: dict) -> dict:
    return {k: v.detach() for k, v in state["params"].items()}


def eval_fields(utt_dir: str, rung: str, decode_name: str, r: dict,
                slug: str | None = None) -> dict:
    """A TEST eval's record fields (WER / CER with their bootstrap 95%
    CIs), after writing its per-utterance ``(we, wc, ce, cc)`` sidecar
    ``<utt_dir>/<slug>.json`` for paired comparisons."""
    if slug is None:
        slug = f"{rung}__{decode_name}".replace("/", "_").replace(" ", "")
    with open(os.path.join(utt_dir, slug + ".json"), "w") as f:
        json.dump({"rung": rung, "decode": decode_name,
                   "per_utt": r["per_utt"]}, f)
    out = {"test_wer": round(r["wer"], 4), "test_cer": round(r["cer"], 4)}
    if "wer_ci95" in r:
        out["test_wer_ci95"] = [round(x, 4) for x in r["wer_ci95"]]
        out["test_cer_ci95"] = [round(x, 4) for x in r["cer_ci95"]]
    return out


def append_record(results_path: str, rec: dict, tag: str) -> None:
    with open(results_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"[{tag}] " + json.dumps(rec), flush=True)


def select_lm_weight(cfg, params, dev_manifest: str, char_lm_path: str,
                     weights, device: str, tag: str):
    """The char-LM fusion weight with the lowest DEV WER (the first of
    equals); returns (config with that weight, weight, its DEV WER)."""
    best_w, best_dev = None, float("inf")
    for w in weights:
        lcfg = dc.replace(cfg, decode=dc.replace(
            cfg.decode, lm_path=char_lm_path, lm_weight=w, word_bonus=0.5))
        rd = eval_split(lcfg, params, dev_manifest, device, log_samples=0)
        print(f"[{tag}] dev sweep lm_weight={w}: wer={rd['wer']:.4f}",
              flush=True)
        if rd["wer"] < best_dev:
            best_dev, best_w = rd["wer"], w
    return (dc.replace(cfg, decode=dc.replace(
        cfg.decode, lm_path=char_lm_path, lm_weight=best_w, word_bonus=0.5)),
        best_w, best_dev)


def select_rescore_alpha(cfg, params, dev_manifest: str, word_lm_path: str,
                         alphas, device: str, tag: str):
    """The word-LM rescoring weight with the lowest DEV WER (the first of
    equals; with alpha = 0 in the grid, rescoring cannot look worse than
    the beam it rescores on DEV); returns (config with that weight,
    weight, its DEV WER)."""
    best_a, best_dev = None, float("inf")
    for a in alphas:
        acfg = dc.replace(cfg, decode=dc.replace(
            cfg.decode, word_lm_path=word_lm_path, rescore_alpha=a))
        rd = eval_split(acfg, params, dev_manifest, device, log_samples=0)
        print(f"[{tag}] dev sweep rescore_alpha={a}: wer={rd['wer']:.4f}",
              flush=True)
        if rd["wer"] < best_dev:
            best_dev, best_a = rd["wer"], a
    return (dc.replace(cfg, decode=dc.replace(
        cfg.decode, word_lm_path=word_lm_path, rescore_alpha=best_a)),
        best_a, best_dev)


def archive_run(out: str, archive: str) -> None:
    """Copy ``out/ladder_results.jsonl`` (every record written under
    ``out``), the per-utterance sidecars (the inputs to ``cli compare``
    and ``analyze_ladder``) and each ``train_*/metrics.jsonl`` into
    ``archive``."""
    os.makedirs(archive, exist_ok=True)
    shutil.copy(os.path.join(out, "ladder_results.jsonl"), archive)
    utt_dir = os.path.join(out, "per_utt")
    if os.path.isdir(utt_dir):
        dst = os.path.join(archive, "per_utt")
        os.makedirs(dst, exist_ok=True)
        for name in os.listdir(utt_dir):
            shutil.copy(os.path.join(utt_dir, name), dst)
    for d in sorted(os.listdir(out)):
        mj = os.path.join(out, d, "metrics.jsonl")
        if d.startswith("train_") and os.path.exists(mj):
            shutil.copy(mj, os.path.join(archive, f"{d}_metrics.jsonl"))
    print(f"[ladder] archived results to {archive}", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="run_ladder_hard")
    ap.add_argument("--out", required=True,
                    help="work directory: corpus, LMs, checkpoints, records")
    ap.add_argument("--rungs", default="pr1,ds2,ds3",
                    help="comma list of pr1, ds2, ds2sa, ds3, ds3sa")
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-dev", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=96)
    ap.add_argument("--snr-low", type=float, default=5.0)
    ap.add_argument("--snr-high", type=float, default=20.0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps-scale", type=float, default=1.0)
    ap.add_argument("--lm-weights", default="0.2,0.4,0.6")
    ap.add_argument("--wire", default="int16",
                    choices=("int16", "ulaw", "float32"),
                    help="the loader's wire dtype for the samples")
    ap.add_argument("--feature-cache", default="",
                    help="a feature cache directory (cli prepare-features "
                         "over train + dev + test): f16 features instead "
                         "of int16 audio")
    ap.add_argument("--specaug-ab", action="store_true",
                    help="train the ds2 rung a second time with "
                         "SpecAugment at equal steps")
    ap.add_argument("--archive", default=None,
                    help="directory to copy ladder_results.jsonl, the "
                         "sidecars and the loss curves into")
    ap.add_argument("--train-seed", type=int, default=None,
                    help="the train seed of every rung (initial weights, "
                         "dropout and SpecAugment); default the preset's, "
                         "as the reference trains")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the ladder; returns the records (also printed as one JSON
    line, ``{"ladder": [...]}``)."""
    args = parse_args(argv)
    from ..ops.dispatch import resolve_device
    from ..train import train
    device = str(resolve_device(args.device))   # raises without a GPU
    os.makedirs(args.out, exist_ok=True)
    man = get_corpus(args.out, args)
    char_lm_path, word_lm_path = train_lms(args.out, man["train"])
    rungs = args.rungs.split(",")
    results = []
    results_path = os.path.join(args.out, "ladder_results.jsonl")
    utt_dir = os.path.join(args.out, "per_utt")
    os.makedirs(utt_dir, exist_ok=True)

    def emit(rec):
        results.append(rec)
        append_record(results_path, rec, "ladder")

    def fields(rung, decode_name, r):
        return eval_fields(utt_dir, rung, decode_name, r)

    sc = args.steps_scale

    def cfg_for(preset_name, rung, steps, lr):
        return rung_cfg(preset_name, man, args.out, rung, steps, args.batch,
                        lr, args.wire, args.feature_cache, args.train_seed)

    def train_and_eval(cfg, rung, decode_name):
        """Train, then evaluate DEV and TEST."""
        t0 = time.time()
        state = train(cfg, device=device)
        wall = round(time.time() - t0, 1)
        params = trained_params(state)
        rd = eval_split(cfg, params, man["dev"], device, log_samples=0)
        r = eval_split(cfg, params, man["test"], device)
        emit({"rung": rung, "decode": decode_name,
              "steps": int(state["step"]), "train_wall_s": wall,
              "dev_wer": round(rd["wer"], 4),
              **fields(rung, decode_name, r), "rtf": round(r["rtf"], 5)})

    def with_specaug(cfg, **train_kw):
        return dc.replace(cfg, train=dc.replace(cfg.train, specaugment=True,
                                                **train_kw))

    if "pr1" in rungs:
        cfg = cfg_for("pr1_mfcc_uni", "pr1", int(2500 * sc), 5e-4)
        train_and_eval(cfg, "pr1_mfcc_uni", "greedy")

    if "ds2" in rungs:
        cfg = cfg_for("conv_bilstm3", "ds2", int(2000 * sc), 5e-4)
        train_and_eval(cfg, "conv_bilstm3", "greedy")
        if args.specaug_ab:
            sa = with_specaug(cfg, train_dir=os.path.join(
                args.out, "train_ds2_specaug"))
            train_and_eval(sa, "conv_bilstm3+specaug", "greedy")

    if "ds2sa" in rungs:
        # the SpecAugment arm alone
        cfg = with_specaug(cfg_for("conv_bilstm3", "ds2_specaug",
                                   int(2000 * sc), 5e-4))
        train_and_eval(cfg, "conv_bilstm3+specaug", "greedy")

    def run_ds3_chain(rung, specaug):
        """One ds3 training serves the greedy (diagnostic), beam,
        + char-LM and + word-LM rungs."""
        cfg = cfg_for("deepspeech_beam", rung, int(2000 * sc), 3e-4)
        if specaug:
            cfg = with_specaug(cfg)
        name = "deepspeech_beam" + ("+specaug" if specaug else "")
        t0 = time.time()
        state = train(cfg, device=device)
        wall = round(time.time() - t0, 1)
        params = trained_params(state)
        steps = int(state["step"])

        gcfg = dc.replace(cfg, decode=dc.replace(cfg.decode,
                                                 method="greedy"))
        r = eval_split(gcfg, params, man["test"], device, log_samples=0)
        emit({"rung": name, "decode": "greedy(diagnostic)", "steps": steps,
              "train_wall_s": wall, **fields(name, "greedy", r),
              "rtf": round(r["rtf"], 5)})

        r = eval_split(cfg, params, man["test"], device)
        emit({"rung": name, "decode": "beam64", "steps": steps,
              **fields(name, "beam64", r), "rtf": round(r["rtf"], 5)})

        # char-LM fusion: the weight selected on DEV, reported on TEST
        lcfg, best_w, best_dev = select_lm_weight(
            cfg, params, man["dev"], char_lm_path,
            [float(x) for x in args.lm_weights.split(",")], device,
            "ladder")
        r = eval_split(lcfg, params, man["test"], device)
        emit({"rung": name + "+lm_fusion",
              "decode": f"beam64+charlm(w={best_w})",
              "dev_wer": round(best_dev, 4),
              **fields(name + "+lm_fusion", "beam64+charlm", r),
              "rtf": round(r["rtf"], 5)})

        # + word-LM N-best rescoring of the fused beam, its alpha selected
        # on DEV
        wcfg, best_a, best_dev_a = select_rescore_alpha(
            lcfg, params, man["dev"], word_lm_path, RESCORE_ALPHAS, device,
            "ladder")
        # TEST twice with one RTF definition (first batch of each bucket
        # excluded, host rescoring included): the second pass is warm
        r = eval_split(wcfg, params, man["test"], device, log_samples=0)
        r2 = eval_split(wcfg, params, man["test"], device, log_samples=0)
        emit({"rung": name + "+lm_fusion+rescore",
              "decode": f"beam64+charlm(w={best_w})+wordlm(a={best_a})",
              "dev_wer": round(best_dev_a, 4),
              **fields(name + "+lm_fusion+rescore", "rescore", r),
              "rtf": round(r["rtf"], 5), "rtf_warm": round(r2["rtf"], 5)})

    if "ds3" in rungs:
        run_ds3_chain("ds3", specaug=False)
    if "ds3sa" in rungs:
        run_ds3_chain("ds3sa", specaug=True)

    print(json.dumps({"ladder": results}), flush=True)
    if args.archive:
        archive_run(args.out, args.archive)
    return results


if __name__ == "__main__":
    main()
