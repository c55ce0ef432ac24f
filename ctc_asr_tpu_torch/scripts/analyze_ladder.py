"""Ladder post-processing: the WER table with bootstrap CIs and the
paired-bootstrap ranking of the best rungs.

Counterpart of ``scripts/analyze_ladder.py``. Reads a ``run_ladder_hard``
output or archive directory (``ladder_results.jsonl`` and
``per_utt/*.json``) and prints

1. a markdown table, one row a record, with the 95% CI columns;
2. the paired bootstrap (``metrics.paired_bootstrap``) between each two
   of the ``--top`` best rungs that have sidecars, each labelled
   decisive or tied;
3. with ``--curves``, for each ``train_*_metrics.jsonl`` beside the
   records: the last logged step, the median of the logged
   ``step_time_s`` (each the mean over ``log_every`` steps) and the
   first and last logged loss.

    python -m ctc_asr_tpu_torch.scripts.analyze_ladder \\
        --dir ctc_asr_tpu_torch/results/ladder_hard_h100 [--top 4] [--curves]

A run is held against another run on the same test split sidecar by
sidecar with ``cli compare``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..metrics import paired_bootstrap
from .run_ladder_hard import LOG_EVERY


def load(dirpath: str) -> tuple[list, dict]:
    """The records, and the sidecars keyed by (rung, decode)."""
    with open(os.path.join(dirpath, "ladder_results.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    utts = {}
    for p in glob.glob(os.path.join(dirpath, "per_utt", "*.json")):
        with open(p) as f:
            d = json.load(f)
        utts[(d["rung"], d["decode"])] = d["per_utt"]
    return rows, utts


def fmt_ci(ci) -> str:
    if not ci:
        return "—"
    return f"[{100*ci[0]:.1f}, {100*ci[1]:.1f}]"


def sidecar_of(record: dict, utts: dict):
    """The sidecar of a record: the same rung, and a decode slug that
    prefixes the record's decode string (``greedy(diagnostic)`` ->
    ``greedy``, ``beam64+charlm(w=..)`` -> ``beam64+charlm``) or the
    ``rescore`` slug of a ``+rescore`` rung. Returns (key, records) or
    None."""
    for (rung, dec), pu in utts.items():
        if rung != record["rung"]:
            continue
        if record.get("decode", "").startswith(dec) or (
                dec == "rescore" and rung.endswith("+rescore")):
            return (rung, dec), pu
    return None


def curves(dirpath: str) -> list:
    """One row a loss curve ``train_*_metrics.jsonl`` of ``dirpath``."""
    rows = []
    for p in sorted(glob.glob(os.path.join(dirpath,
                                           "train_*_metrics.jsonl"))):
        with open(p) as f:
            recs = [r for r in map(json.loads, f) if "loss" in r]
        # the trainer divides a last, partial window by the whole
        # LOG_EVERY: only whole windows count
        full = [r["step_time_s"] for r in recs
                if r["step"] % LOG_EVERY == 0] or [recs[-1]["step_time_s"]]
        rows.append({"run": os.path.basename(p)[:-len("_metrics.jsonl")],
                     "steps": recs[-1]["step"],
                     "step_time_s": float(np.median(full)),
                     "loss_first": recs[0]["loss"],
                     "loss_last": recs[-1]["loss"]})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="analyze_ladder")
    ap.add_argument("--dir", required=True,
                    help="a run_ladder_hard --out or --archive directory")
    ap.add_argument("--top", type=int, default=4)
    ap.add_argument("--curves", action="store_true",
                    help="also summarize the train_*_metrics.jsonl curves")
    args = ap.parse_args(argv)
    rows, utts = load(args.dir)

    print("| Rung | decode | steps | dev WER | test WER | 95% CI | "
          "test CER | eval RTF |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        dev = f"{100*r['dev_wer']:.1f}%" if "dev_wer" in r else "—"
        rtf = f"{r.get('rtf', 0):.3f}"
        if "rtf_warm" in r:
            rtf += f" ({r['rtf_warm']:.3f} warm)"
        print(f"| {r['rung']} | {r['decode']} | {r.get('steps', '—')} | "
              f"{dev} | **{100*r['test_wer']:.2f}%** | "
              f"{fmt_ci(r.get('test_wer_ci95'))} | "
              f"{100*r['test_cer']:.2f}% | {rtf} |")

    scored = sorted((r for r in rows if "test_wer" in r),
                    key=lambda r: r["test_wer"])
    best, seen = [], set()
    for r in scored:
        match = sidecar_of(r, utts)
        if match and match[0] not in seen:
            seen.add(match[0])
            best.append((r, *match))
        if len(best) >= args.top:
            break

    print("\n## Paired bootstrap among the top rungs (A vs B = "
          "delta, CI95, p(A better))\n")
    for i in range(len(best)):
        for j in range(i + 1, len(best)):
            (_, ka, pa), (_, kb, pb) = best[i], best[j]
            if len(pa) != len(pb):
                continue
            out = paired_bootstrap(pa, pb)
            lo, hi = out["wer_delta_ci95"]
            verdict = "A better" if hi < 0 else \
                "B better" if lo > 0 else "TIED"
            print(f"- {ka[0]}/{ka[1]} vs {kb[0]}/{kb[1]}: "
                  f"delta={out['wer_delta']:+.4f} "
                  f"CI[{lo:+.4f},{hi:+.4f}] "
                  f"p={out['p_a_better']:.3f} -> {verdict}")

    if args.curves:
        print("\n## Loss curves\n")
        print("| run | steps | median step_time_s | first loss | last loss |")
        print("|---|---|---|---|---|")
        for r in curves(args.dir):
            print(f"| {r['run']} | {r['steps']} | {r['step_time_s']:.5f} | "
                  f"{r['loss_first']:.3f} | {r['loss_last']:.3f} |")


if __name__ == "__main__":
    main()
