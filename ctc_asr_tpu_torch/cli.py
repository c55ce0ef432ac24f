"""Command-line entry points of the port:

    python -m ctc_asr_tpu_torch.cli train --preset conv_bilstm3 \
        --data.train_manifest=M.csv [--max-steps N] [--device=cuda] \
        [--section.key=value ...]
    python -m ctc_asr_tpu_torch.cli evaluate --preset conv_bilstm3 \
        --ckpt CKPT [--device=cuda] [--dump-utts a.json] [--section.key=value ...]
    python -m ctc_asr_tpu_torch.cli transcribe --preset conv_bilstm3 \
        --ckpt CKPT [--device=cuda] wav...
    python -m ctc_asr_tpu_torch.cli train-lm --manifest M.csv --out lm.npz \
        [--order 4] [--words]
    python -m ctc_asr_tpu_torch.cli compare a.json b.json
    python -m ctc_asr_tpu_torch.cli prepare-synth --out DIR [--n 64]
    python -m ctc_asr_tpu_torch.cli prepare-synth-hard --out DIR
    python -m ctc_asr_tpu_torch.cli prepare-librispeech --root DIR --out DIR
    python -m ctc_asr_tpu_torch.cli prepare-corpus \
        {common-voice,tedlium,timit,tatoeba,merge} [--root DIR] --out OUT
    python -m ctc_asr_tpu_torch.cli compute-stats --preset ... \
        --manifest M.csv --out stats.npz [--device=cuda]
    python -m ctc_asr_tpu_torch.cli prepare-features --preset ... \
        --manifest M.csv --out DIR [--dtype float16|int8] [--device=cuda]

``compute-stats`` writes the npz that ``--features.stats_path`` names
(``--features.normalization=global``); ``prepare-features`` writes the
feature cache that ``train`` / ``evaluate`` read with
``--data.feature_cache=DIR``. Both files are the reference's formats.

Beam decoding: ``--preset lm_fusion_960h --decode.lm_path=lm.npz`` fuses
a char LM from ``train-lm`` into the beam; ``--decode.word_lm_path=w.pkl``
(from ``train-lm --words``) adds word-LM rescoring of the N-best on the
host; ``--preset deepspeech_beam`` is the acoustic-only beam.

The surface is the reference CLI's (``ctc_asr_tpu/cli.py``): ``--preset``
picks a preset, ``--config file.json`` loads a full config, and any
``--section.key=value`` overrides it. ``--ckpt`` is a ``.npz`` written by
either package's ``save_checkpoint`` or a train dir. ``train`` resumes
from the newest checkpoint in ``train.train_dir`` and evaluates every
``train.eval_every`` steps when ``data.eval_manifest`` is set.
``--device`` defaults to ``cuda``, and asking for CUDA where there is
none raises.

Data parallelism: start ``train`` or ``evaluate`` once a process with
``--mesh.coordinator_address=HOST:PORT --mesh.num_processes=N
--mesh.process_id=R``; the processes form a ``torch.distributed`` group
(NCCL with ``--device=cuda``, on card ``R % device_count``; gloo with
``--device=cpu``), each trains or decodes its shard of the manifest, and
process 0 writes the metrics, the checkpoints and ``--dump-utts``.
``transcribe`` runs in one process.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import config as cfg_mod


def _split_args(argv):
    """Separate --section.key=value overrides from plain args."""
    overrides, rest = {}, []
    for a in argv:
        if a.startswith("--") and "=" in a and "." in a.split("=", 1)[0]:
            k, v = a[2:].split("=", 1)
            overrides[k] = v
        else:
            rest.append(a)
    return overrides, rest


def _load_cfg(args, overrides) -> cfg_mod.Config:
    if args.config:
        with open(args.config) as f:
            cfg = cfg_mod.from_json(f.read())
    elif args.preset:
        cfg = cfg_mod.preset(args.preset)
    else:
        cfg = cfg_mod.Config()
    if overrides:
        cfg = cfg_mod.apply_overrides(cfg, overrides)
    return cfg


def _parser(prog: str, ckpt: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("--preset", default="",
                   help="named preset (config.preset)")
    p.add_argument("--config", default="", help="config json file")
    if ckpt:
        p.add_argument("--ckpt", required=True,
                       help="checkpoint .npz (or train dir)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p


def cmd_train(argv):
    overrides, rest = _split_args(argv)
    p = _parser("train", ckpt=False)
    p.add_argument("--max-steps", type=int, default=None)
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)

    from .evaluate import evaluate
    from .parallel import initialize_distributed
    from .train import train

    formed = initialize_distributed(cfg.mesh, args.device)
    eval_fn = None
    if cfg.data.eval_manifest:
        def eval_fn(state):       # on every rank, each on its shard
            params = {k: v.detach() for k, v in state["params"].items()}
            params.update(state["model_state"])
            res = evaluate(cfg, params, args.device, log_samples=2)
            res.pop("per_utt", None)
            res.pop("device", None)
            return res
    try:
        state = train(cfg, args.device, max_steps=args.max_steps,
                      eval_fn=eval_fn)
    finally:
        if formed:
            _leave_group()
    print(f"[train] done at step {state['step']}")
    return 0


def _leave_group() -> None:
    import torch.distributed as dist
    dist.destroy_process_group()


def cmd_evaluate(argv):
    overrides, rest = _split_args(argv)
    p = _parser("evaluate")
    p.add_argument("--dump-utts", default="",
                   help="write per-utterance (we,wc,ce,cc) records to "
                        "this JSON for `cli compare`")
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)

    from .checkpoint import load_params, resolve_checkpoint
    from .evaluate import evaluate
    from .parallel import initialize_distributed
    from .train import check_regime

    formed = initialize_distributed(cfg.mesh, args.device)
    try:
        rank = check_regime(cfg).rank
        params = load_params(args.ckpt, cfg, args.device)
        res = evaluate(cfg, params, args.device)
    finally:
        if formed:
            _leave_group()
    per_utt = res.pop("per_utt")
    # the records are gathered: process 0's dump is the whole corpus
    if args.dump_utts and rank == 0:
        with open(args.dump_utts, "w") as f:
            json.dump({"ckpt": resolve_checkpoint(args.ckpt),
                       "per_utt": per_utt}, f)
    print(json.dumps(res, indent=2, default=float))
    return 0


def cmd_transcribe(argv):
    overrides, rest = _split_args(argv)
    p = _parser("transcribe")
    p.add_argument("wavs", nargs="+")
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)

    from .checkpoint import load_params
    from .transcribe import Transcriber, check_single_process

    check_single_process(cfg)
    tr = Transcriber(cfg, load_params(args.ckpt, cfg, args.device),
                     args.device)
    for wav in args.wavs:
        print(f"{wav}\t{tr.transcribe_file(wav)}")
    return 0


def cmd_compare(argv):
    """Paired-bootstrap comparison of two systems evaluated on the SAME
    manifest: `cli compare a.json b.json` where each file is an
    `evaluate --dump-utts` dump or a ladder per_utt sidecar. Reports the
    corpus-WER delta (A - B), its 95% CI, and p(A better)
    (metrics.paired_bootstrap). Raises when the two disagree on any
    utterance's reference word and character counts (wc, cc): then the
    utterances or their order differ and no delta means anything."""
    p = argparse.ArgumentParser(prog="compare")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--resamples", type=int, default=2000)
    args = p.parse_args(argv)
    from .metrics import paired_bootstrap
    recs = []
    for path in (args.a, args.b):
        with open(path) as f:
            recs.append(json.load(f)["per_utt"])
    counts = [[(u[1], u[3]) for u in rs] for rs in recs]
    if counts[0] != counts[1]:
        raise ValueError(f"{args.a} and {args.b}: the per-utterance "
                         f"(wc, cc) differ (another split or order)")
    out = paired_bootstrap(recs[0], recs[1], n_resamples=args.resamples)
    print(json.dumps(out, indent=2))
    lo, hi = out["wer_delta_ci95"]
    verdict = "A better" if hi < 0 else \
        "B better" if lo > 0 else "statistically tied"
    print(f"# {verdict} (delta={out['wer_delta']:+.4f}, "
          f"CI95=[{lo:+.4f}, {hi:+.4f}], "
          f"p_a_better={out['p_a_better']:.3f})")
    return 0


def cmd_prepare_synth(argv):
    p = argparse.ArgumentParser(prog="prepare-synth")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-words", type=int, default=2)
    p.add_argument("--max-words", type=int, default=7)
    args = p.parse_args(argv)
    from .data.synth import generate_corpus
    path = generate_corpus(args.out, num_utterances=args.n, seed=args.seed,
                           min_words=args.min_words,
                           max_words=args.max_words)
    print(path)
    return 0


def cmd_prepare_synth_hard(argv):
    p = argparse.ArgumentParser(
        prog="prepare-synth-hard",
        description="Discriminating synthetic corpus: speaker formant/"
                    "speed perturbation, additive noise at SNR, tone "
                    "babble, disjoint train/dev/test splits with "
                    "held-out test speakers.")
    p.add_argument("--out", required=True)
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--n-dev", type=int, default=64)
    p.add_argument("--n-test", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab-size", type=int, default=384)
    p.add_argument("--snr-low", type=float, default=5.0)
    p.add_argument("--snr-high", type=float, default=20.0)
    args = p.parse_args(argv)
    from .data.synth import generate_hard_corpus
    m = generate_hard_corpus(
        args.out, n_train=args.n_train, n_dev=args.n_dev,
        n_test=args.n_test, seed=args.seed, vocab_size=args.vocab_size,
        snr_db=(args.snr_low, args.snr_high))
    for k in ("train", "dev", "test"):
        print(f"{k}\t{m[k]}")
    return 0


def cmd_prepare_librispeech(argv):
    p = argparse.ArgumentParser(prog="prepare-librispeech")
    p.add_argument("--root", required=True,
                   help="extracted LibriSpeech root (contains e.g. "
                        "train-clean-100/)")
    p.add_argument("--out", required=True)
    p.add_argument("--subsets", nargs="*", default=None)
    p.add_argument("--no-convert", action="store_true",
                   help="manifest points straight at the original "
                        ".flac files (native decoder reads them in "
                        "the loader; no wav copies on disk)")
    args = p.parse_args(argv)
    from .data.generate import prepare_librispeech
    for path in prepare_librispeech(args.root, args.out, args.subsets,
                                    convert=not args.no_convert):
        print(path)
    return 0


def cmd_prepare_corpus(argv):
    """Per-corpus dataset generation + merge."""
    p = argparse.ArgumentParser(prog="prepare-corpus")
    p.add_argument("corpus",
                   choices=["common-voice", "tedlium", "timit", "tatoeba",
                            "merge"])
    p.add_argument("--root", help="extracted corpus root (not for merge)")
    p.add_argument("--out", required=True)
    p.add_argument("--split", default=None,
                   help="corpus split (tedlium: train/dev/test; timit: "
                        "TRAIN/TEST; common-voice: a .tsv name)")
    p.add_argument("--lang", default="eng", help="tatoeba language code")
    p.add_argument("--manifests", nargs="*", default=[],
                   help="input manifest CSVs (merge only)")
    args = p.parse_args(argv)
    from .data import generate as gen
    if args.corpus == "merge":
        if not args.manifests:
            p.error("merge requires --manifests")
        print(gen.merge_manifests(args.manifests, args.out))
        return 0
    if not args.root:
        p.error(f"{args.corpus} requires --root")
    if args.corpus == "common-voice":
        kw = {"split_tsv": args.split} if args.split else {}
        print(gen.prepare_common_voice(args.root, args.out, **kw))
    elif args.corpus == "tedlium":
        kw = {"split": args.split} if args.split else {}
        print(gen.prepare_tedlium(args.root, args.out, **kw))
    elif args.corpus == "timit":
        kw = {"split": args.split} if args.split else {}
        print(gen.prepare_timit(args.root, args.out, **kw))
    elif args.corpus == "tatoeba":
        print(gen.prepare_tatoeba(args.root, args.out, lang=args.lang))
    return 0


def cmd_train_lm(argv):
    p = argparse.ArgumentParser(prog="train-lm")
    p.add_argument("--manifest", required=True, nargs="+")
    p.add_argument("--out", required=True)
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--words", action="store_true",
                   help="train a word-level LM (for N-best rescoring) "
                        "instead of the char LM (for shallow fusion)")
    args = p.parse_args(argv)
    from .data.manifest import read_manifest
    from .ops import lm as lm_mod
    texts = []
    for m in args.manifest:
        texts.extend(u.transcript for u in read_manifest(m))
    if args.words:
        wlm = lm_mod.train_word_lm(texts, order=max(args.order, 1))
        lm_mod.save_word_lm(args.out, wlm)
        print(f"wrote {args.out} (word LM, order={wlm['order']}, "
              f"|V|={len(wlm['vocab'])})")
    else:
        lm = lm_mod.train_char_lm(texts, order=args.order)
        lm_mod.save_lm(args.out, lm)
        print(f"wrote {args.out} (char LM, order={args.order}, "
              f"table={lm['table'].shape})")
    return 0


def cmd_compute_stats(argv):
    overrides, rest = _split_args(argv)
    p = _parser("compute-stats", ckpt=False)
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-batches", type=int, default=None)
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)
    from .data.manifest import read_manifest
    from .features import compute_dataset_stats
    res = compute_dataset_stats(read_manifest(args.manifest), cfg.data,
                                cfg.features, args.out,
                                max_batches=args.max_batches,
                                device=args.device)
    print(f"wrote {args.out} ({int(res['frames'])} frames)")
    return 0


def cmd_prepare_features(argv):
    """Precompute the feature cache for a manifest (data/feature_cache.py);
    train/evaluate consume it via --data.feature_cache=DIR."""
    overrides, rest = _split_args(argv)
    p = _parser("prepare-features", ckpt=False)
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", default="float16",
                   choices=("float16", "int8"),
                   help="cache wire dtype; int8 halves upload bytes "
                        "again (fixed-scale quantization)")
    args = p.parse_args(rest)
    cfg = _load_cfg(args, overrides)
    from .data.feature_cache import build_feature_cache
    from .data.manifest import read_manifest
    build_feature_cache(read_manifest(args.manifest), cfg.data,
                        cfg.features, args.out, dtype=args.dtype,
                        device=args.device)
    print(args.out)
    return 0


COMMANDS = {
    "train": cmd_train,
    "evaluate": cmd_evaluate,
    "compare": cmd_compare,
    "transcribe": cmd_transcribe,
    "prepare-synth": cmd_prepare_synth,
    "prepare-synth-hard": cmd_prepare_synth_hard,
    "prepare-librispeech": cmd_prepare_librispeech,
    "prepare-corpus": cmd_prepare_corpus,
    "train-lm": cmd_train_lm,
    "compute-stats": cmd_compute_stats,
    "prepare-features": cmd_prepare_features,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; have {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    return COMMANDS[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
