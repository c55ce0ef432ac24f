"""Where a model's word errors on unseen words come from: its hypotheses,
the word boundaries it inserts or drops, and the greedy path's blank and
space posteriors, reference word by reference word.

A port-only diagnostic beside the runners (the reference's
``scripts/diag_*`` are its kind). It decodes a manifest with a
checkpoint through ``evaluate`` (the eval step and the decoder that the
records use), checks that its per-utterance ``(we, wc, ce, cc)`` equal
``evaluate``'s and, given ``--sidecar``, those of the record's sidecar
for the same checkpoint (it exits 1 where they differ), and writes one
JSON file:

- ``utts``: per utterance the reference, the hypothesis, the greedy
  path's hypothesis, ``(we, wc, ce, cc)`` and per reference word
  ``[word, in_vocab, spaces_inside, boundary_dropped_after, frames,
  blank_posterior_sum, space_posterior_sum]``;
- ``summary``: those counts and the frame-weighted mean posteriors by
  class of word, in-vocabulary (a word of ``--vocab-manifest``'s
  transcripts) and out of it.

Boundaries come from a character alignment of the reference and the
hypothesis (``boundary_errors``): a space inside the hypothesis span of
a reference word splits it; a reference boundary whose two words map
into one hypothesis word was dropped (merged). Frames come from the
greedy path: each emitted character owns its run's frames and the
blanks after it, and belongs to the reference word whose aligned span
holds it.

    python -m ctc_asr_tpu_torch.scripts.diag_oov_boundaries \\
        --preset deepspeech_beam \\
        --ckpt R4BIG/train_ds3sa/ckpt/step_00008000.npz \\
        --manifest OOV/oov_test.csv --vocab-manifest R4BIG/corpus/train.csv \\
        --decode greedy --sidecar OOV/per_utt/oov_ds3sa8000_greedy.json \\
        --out DIAG/ds3sa_oov_greedy.json

``--decode`` is ``greedy`` or ``beam64`` (the records' beam); the data
settings are ``run_oov.arm_cfg``'s, which the r4big records share.
Runs on ``--device`` (``cuda`` by default; ``cpu`` on request).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..metrics import levenshtein
from ..text import ALPHABET, BLANK_ID

SPACE_ID = ALPHABET.index(" ")


def align_chars(ref: str, hyp: str) -> list:
    """A minimum-cost alignment of two strings: for each reference
    character the index of the hypothesis character it is matched or
    substituted with, or None where it is deleted. It matches as many
    letters as it can and lets the spaces fall where they are: a
    letter's deletion or insertion costs 3, a space's 2, a letter for
    another 3, a space for a letter 5 (its deletion and an insertion;
    the substitution is kept where they tie). So a boundary moved by a
    letter aligns as one boundary dropped and one space inside a word.
    Ties take the diagonal, then a deletion."""
    def sub(a, b):
        return 0 if a == b else 5 if (a == " ") != (b == " ") else 3

    def indel(c):
        return 2 if c == " " else 3

    n, m = len(ref), len(hyp)
    d = [[0] * (m + 1) for _ in range(n + 1)]
    for j in range(1, m + 1):
        d[0][j] = d[0][j - 1] + indel(hyp[j - 1])
    for i in range(1, n + 1):
        row, up = d[i], d[i - 1]
        row[0] = up[0] + indel(ref[i - 1])
        for j in range(1, m + 1):
            row[j] = min(up[j - 1] + sub(ref[i - 1], hyp[j - 1]),
                         up[j] + indel(ref[i - 1]),
                         row[j - 1] + indel(hyp[j - 1]))
    out = [None] * n
    i, j = n, m
    while i > 0 and j > 0:
        if d[i][j] == d[i - 1][j - 1] + sub(ref[i - 1], hyp[j - 1]):
            out[i - 1] = j - 1
            i, j = i - 1, j - 1
        elif d[i][j] == d[i - 1][j] + indel(ref[i - 1]):
            i -= 1
        else:
            j -= 1
    return out


def word_spans(text: str) -> list:
    """[(start, end)] character spans of the space-separated words."""
    spans, start = [], None
    for i, c in enumerate(text + " "):
        if c != " " and start is None:
            start = i
        elif c == " " and start is not None:
            spans.append((start, i))
            start = None
    return spans


def boundary_errors(ref: str, hyp: str) -> dict:
    """Word boundaries of ``hyp`` against ``ref``, from ``align_chars``.

    - ``spaces_inside[w]``: spaces of the hypothesis strictly inside the
      span of hypothesis characters aligned to reference word w (each
      splits the word; a word with no aligned character has 0);
    - ``dropped[b]``: the boundary after reference word b maps to no
      space: the last aligned character of word b and the first of
      word b+1 lie in one hypothesis word (False where either word has
      no aligned character);
    - ``span[w]``: (first, last) hypothesis index aligned to word w, or
      None."""
    words = word_spans(ref)
    at = align_chars(ref, hyp)
    spans = []
    for s, e in words:
        js = [at[i] for i in range(s, e) if at[i] is not None]
        spans.append((min(js), max(js)) if js else None)
    inside = [0 if sp is None else
              sum(hyp[j] == " " for j in range(sp[0] + 1, sp[1]))
              for sp in spans]
    dropped = []
    for a, b in zip(spans, spans[1:]):
        dropped.append(a is not None and b is not None and
                       " " not in hyp[a[1] + 1:b[0]])
    return {"spaces_inside": inside, "dropped": dropped, "span": spans}


def greedy_frames(path: np.ndarray) -> tuple[str, list]:
    """A greedy path (argmax class per valid frame) -> (its text, for
    each emitted character the frames it owns: its run and the blanks
    after it)."""
    chars, starts = [], []
    prev = -1
    for t, c in enumerate(path.tolist()):
        if c != BLANK_ID and c != prev:
            chars.append(ALPHABET[c])
            starts.append(t)
        prev = c
    ends = starts[1:] + [len(path)]
    return "".join(chars), list(zip(starts, ends))


def diagnose_utt(ref: str, hyp: str, path: np.ndarray, p_blank: np.ndarray,
                 p_space: np.ndarray, vocab: set) -> dict:
    """The record of one utterance (see the module's docstring)."""
    be = boundary_errors(ref, hyp)
    ghyp, owned = greedy_frames(path)
    gspan = boundary_errors(ref, ghyp)["span"]
    words = ref.split()
    rows = []
    for w, word in enumerate(words):
        frames, sb, ss = 0, 0.0, 0.0
        if gspan[w] is not None:
            lo, hi = gspan[w]
            for s, e in owned[lo:hi + 1]:
                frames += e - s
                sb += float(p_blank[s:e].sum())
                ss += float(p_space[s:e].sum())
        rows.append([word, word in vocab, be["spaces_inside"][w],
                     w < len(be["dropped"]) and be["dropped"][w],
                     frames, sb, ss])
    rw, hw = words, hyp.split()
    return {"ref": ref, "hyp": hyp, "greedy_hyp": ghyp,
            "record": [levenshtein(rw, hw), len(rw), levenshtein(ref, hyp),
                       len(ref)],
            "words": rows}


def summarize(utts: list) -> dict:
    """Counts over every reference word, by class (in / out of the
    vocabulary), and the frame-weighted mean posteriors."""
    out = {"utterances": len(utts),
           "ref_words": sum(u["record"][1] for u in utts),
           "hyp_words": sum(len(u["hyp"].split()) for u in utts),
           "word_errors": sum(u["record"][0] for u in utts),
           "char_errors": sum(u["record"][2] for u in utts),
           "chars": sum(u["record"][3] for u in utts),
           "utts_more_hyp_words": sum(len(u["hyp"].split()) > u["record"][1]
                                      for u in utts)}
    for cls, flag in (("in_vocab", True), ("oov", False)):
        rows = [r for u in utts for r in u["words"] if r[1] == flag]
        frames = sum(r[4] for r in rows)
        out[cls] = {
            "words": len(rows),
            "split_words": sum(r[2] > 0 for r in rows),
            "spaces_inside": sum(r[2] for r in rows),
            "boundaries_dropped_after": sum(bool(r[3]) for r in rows),
            "frames": frames,
            "blank_posterior": sum(r[5] for r in rows) / max(frames, 1),
            "space_posterior": sum(r[6] for r in rows) / max(frames, 1)}
    out["wer"] = out["word_errors"] / max(out["ref_words"], 1)
    out["cer"] = out["char_errors"] / max(out["chars"], 1)
    return out


def diagnose(cfg, params, manifest: str, vocab: set, device: str) -> tuple:
    """Decode ``manifest`` through ``evaluate``; returns (the per-utterance
    diagnostics in the loader's order, ``evaluate``'s result)."""
    import torch
    from .run_ladder_hard import eval_split
    utts = []

    def on_batch(batch, logits, logit_lens, hyps):
        # the greedy decoder's argmax, over the logits themselves
        path = logits.argmax(dim=-1).cpu().numpy()
        lp = torch.log_softmax(logits.float(), dim=-1)
        p_blank = lp[..., BLANK_ID].exp().cpu().numpy()
        p_space = lp[..., SPACE_ID].exp().cpu().numpy()
        lens = logit_lens.cpu().numpy()
        for i, hyp in enumerate(hyps):
            n = int(lens[i])
            utts.append(diagnose_utt(batch.transcripts[i], hyp, path[i, :n],
                                     p_blank[i, :n], p_space[i, :n], vocab))

    res = eval_split(cfg, params, manifest, device, log_samples=0,
                     on_batch=on_batch)
    return utts, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="diag_oov_boundaries")
    ap.add_argument("--preset", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--vocab-manifest", required=True,
                    help="the acoustic train split: its words are in "
                         "the vocabulary")
    ap.add_argument("--decode", choices=("greedy", "beam64"),
                    default="greedy")
    ap.add_argument("--sidecar", default="",
                    help="the record's per-utterance sidecar for the same "
                         "checkpoint and decode, to be equalled")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    from .. import checkpoint
    from ..data import read_manifest
    from ..ops.dispatch import resolve_device
    from .run_oov import BEAM_WIDTH, arm_cfg, with_decode
    device = str(resolve_device(args.device))   # raises without a GPU
    cfg = arm_cfg(args.preset, args.manifest)
    cfg = with_decode(cfg, method="greedy") if args.decode == "greedy" \
        else with_decode(cfg, method="beam", beam_width=BEAM_WIDTH)
    params = checkpoint.load_params(args.ckpt, cfg, device=device)
    vocab = {w for u in read_manifest(args.vocab_manifest)
             for w in u.transcript.split()}
    utts, res = diagnose(cfg, params, args.manifest, vocab, device)
    records = [u["record"] for u in utts]
    bad = []
    if records != [list(r) for r in res["per_utt"]]:
        bad.append("evaluate's per-utterance records")
    if args.decode == "greedy" and any(u["hyp"] != u["greedy_hyp"]
                                       for u in utts):
        bad.append("the greedy decoder's hypotheses")
    if args.sidecar:
        with open(args.sidecar) as f:
            side = [list(r) for r in json.load(f)["per_utt"]]
        if records != side:
            n = sum(a != b for a, b in zip(records, side))
            bad.append(f"the sidecar {args.sidecar} ({n} of {len(side)} "
                       f"utterances differ, {len(records)} decoded)")
    summary = summarize(utts)
    summary.update(decode=args.decode, manifest=args.manifest,
                   ckpt=args.ckpt, matches_sidecar=bool(args.sidecar)
                   and not bad)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "utts": utts}, f)
    print("[diag] " + json.dumps(summary), flush=True)
    if bad:
        print(f"[diag] the records differ from {'; '.join(bad)}",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
