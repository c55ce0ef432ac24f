"""Continue a ladder rung's training from its checkpoint and evaluate it.

Counterpart of ``scripts/continue_rung.py``. ``run_ladder_hard`` trains
each arm once; this resumes a rung's ``train_<rung>`` directory to a
larger step budget (the loader's cursor is in the checkpoint, so the
data order continues exactly) and appends the same record shape, with a
``"continued": true`` marker, to ``ladder_results.jsonl``, and writes the
per-utterance sidecars ``<rung>__<decode>@<steps>.json``.

    python -m ctc_asr_tpu_torch.scripts.continue_rung --out /tmp/ladder \\
        --rung ds3sa --steps 8000 [--chain] [--archive DIR]
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import os
import shutil
import time

from . import run_ladder_hard as lh

RUNG_PRESETS = {
    "pr1": ("pr1_mfcc_uni", 5e-4, False),
    "ds2": ("conv_bilstm3", 5e-4, False),
    "ds2_specaug": ("conv_bilstm3", 5e-4, True),
    "ds3": ("deepspeech_beam", 3e-4, False),
    "ds3sa": ("deepspeech_beam", 3e-4, True),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="continue_rung")
    ap.add_argument("--out", required=True,
                    help="the run_ladder_hard --out of the rung")
    ap.add_argument("--rung", required=True, choices=sorted(RUNG_PRESETS))
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lm-weights", default="0.2,0.4,0.6")
    ap.add_argument("--chain", action="store_true",
                    help="also run beam64 and the DEV-selected char-LM "
                         "fusion")
    ap.add_argument("--archive", default=None,
                    help="directory to copy ladder_results.jsonl into")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    from ..ops.dispatch import resolve_device
    from ..train import train
    device = str(resolve_device(args.device))   # raises without a GPU

    preset_name, lr, specaug = RUNG_PRESETS[args.rung]
    man = {k: os.path.join(args.out, "corpus", f"{k}.csv")
           for k in ("train", "dev", "test")}
    cfg = lh.rung_cfg(preset_name, man, args.out, args.rung, args.steps,
                      args.batch, lr)
    if specaug:
        cfg = dc.replace(cfg, train=dc.replace(cfg.train,
                                               specaugment=True))
    results_path = os.path.join(args.out, "ladder_results.jsonl")
    utt_dir = os.path.join(args.out, "per_utt")
    os.makedirs(utt_dir, exist_ok=True)

    def emit(rec):
        lh.append_record(results_path, rec, "continue")

    def fields(rung, decode_name, r):
        slug = f"{rung}__{decode_name}@{args.steps}".replace("/", "_")
        return lh.eval_fields(utt_dir, rung, decode_name, r, slug=slug)

    t0 = time.time()
    state = train(cfg, device=device)
    wall = round(time.time() - t0, 1)
    params = lh.trained_params(state)
    steps = int(state["step"])
    name = preset_name + ("+specaug" if specaug else "")

    gcfg = dc.replace(cfg, decode=dc.replace(cfg.decode, method="greedy"))
    rd = lh.eval_split(gcfg, params, man["dev"], device, log_samples=0)
    r = lh.eval_split(gcfg, params, man["test"], device, log_samples=0)
    emit({"rung": name, "decode": "greedy", "steps": steps,
          "continued": True, "train_wall_s": wall,
          "dev_wer": round(rd["wer"], 4), **fields(name, "greedy", r),
          "rtf": round(r["rtf"], 5)})

    if args.chain and cfg.decode.method == "beam":
        r = lh.eval_split(cfg, params, man["test"], device, log_samples=0)
        emit({"rung": name, "decode": "beam64", "steps": steps,
              "continued": True, **fields(name, "beam64", r),
              "rtf": round(r["rtf"], 5)})
        lcfg, best_w, best_dev = lh.select_lm_weight(
            cfg, params, man["dev"], os.path.join(args.out, "charlm.npz"),
            [float(x) for x in args.lm_weights.split(",")], device,
            "continue")
        r = lh.eval_split(lcfg, params, man["test"], device, log_samples=0)
        emit({"rung": name + "+lm_fusion",
              "decode": f"beam64+charlm(w={best_w})", "steps": steps,
              "continued": True, "dev_wer": round(best_dev, 4),
              **fields(name + "+lm_fusion", "beam64+charlm", r),
              "rtf": round(r["rtf"], 5)})

    if args.archive:
        os.makedirs(args.archive, exist_ok=True)
        shutil.copy(results_path, args.archive)


if __name__ == "__main__":
    main()
