"""The readings that a cell's limits are set from, on the chip at the cell's
own sizes (or ``--tiny`` on the CPU):

    python3 asrbench/controls.py --workload <cell> --seeds 1,2,3 \
        [--program] [--control] [--faults]

- ``--program``: the program's readings, through the same set-up, path
  and judge as a run (training: its first three steps; decoding: one
  cycle of batches after the warm-up), with no measured window;
- ``--control``: the reference itself put in the program's place,
  computed in float8 e4m3 (the family's steps handed ``quant="fp8"``),
  the precision below the configuration's bf16;
- ``--faults``: the reference (training) or the program (decoding) with
  a fault planted: half of each batch left out and the mean taken over
  the rest; one character of one answer of each judged batch altered;
  the eval step's logits scaled by ``HEAD_FAULT_SCALE``, which keeps
  every frame's top class and changes the rest of the distribution.

One JSON line a seed and kind; nothing here runs in a benchmark run.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD_FAULT_SCALE = 1.5


def _train(ctx, torch, dev, args, emit):
    from asrbench.drivers import train as dtrain
    from asrbench import traffic, weights
    b1 = ctx.cfg["train"]["adam_b1"]
    if args.program:
        parts, first = dtrain.setup(ctx, torch, dev)
        parts.feed.close()
        parts.pre.close()
        del parts
        emit("program", dtrain.reference_readings(ctx, torch, dev, first))
    need = args.control or args.faults
    if not need:
        return
    stream = traffic.Stream(traffic.plan(ctx.mix), ctx.seed)
    batches = []
    for j in range(dtrain.FIRST_STEPS):
        b = stream.batch(j)
        batches.append({k: torch.as_tensor(np.ascontiguousarray(v),
                                           device=dev)
                        for k, v in (("samples", b.samples),
                                     ("sample_lengths", b.sample_lengths),
                                     ("labels", b.labels),
                                     ("label_lengths", b.label_lengths))})
    B = batches[0]["samples"].shape[0]
    kinds = ([("control_fp8", "fp8", None)] if args.control else []) + (
        [("fault_half_batch", None, torch.arange(B // 2, device=dev))]
        if args.faults else [])
    for name, quant, rows in kinds:
        params0 = weights.make_params(ctx.family, ctx.cfg, ctx.seed, dev)
        got = ctx.family.train_steps(params0, batches, ctx.cfg, quant=quant,
                                     rows=rows)
        first = {"losses": got["losses"],
                 "mu1": {k: v * (1.0 - b1) for k, v in got["grads1"].items()},
                 "params": got["params"]}
        del got
        emit(name, dtrain.reference_readings(ctx, torch, dev, first))


def _decode(ctx, torch, dev, args, emit):
    from asrbench.drivers import decode as ddec
    lm_dir = tempfile.mkdtemp(prefix="asrbench-lm-",
                              dir=os.environ.get("TMPDIR"))
    try:
        parts, cfg = ddec.setup(ctx, torch, dev, lm_dir)
        cycle = parts.plan.cycle
        ddec.batch_loop(parts, torch, dev, 0, cycle, dev.type == "cuda")
        judged = set(ddec.sample_batches(ctx, parts.plan,
                                         range(cycle, 2 * cycle)))

        def judged_cycle():
            kept = {}

            def on_done(batch, ids, lens, texts, handed, rescore, logits,
                        llens):
                if batch.index in judged:
                    kept[batch.index] = ddec.keep(ids, lens, batch.valid,
                                                  logits, llens)
            ddec.batch_loop(parts, torch, dev, cycle, cycle,
                            dev.type == "cuda", on_done)
            return kept
        kept = judged_cycle()
        if args.faults:
            step = parts.eval_step

            def scaled(params, samples, lengths):
                logits, lens = step(params, samples, lengths)
                return logits * HEAD_FAULT_SCALE, lens
            parts.eval_step = scaled
            kept_scaled = judged_cycle()
        del parts
        if args.program:
            emit("program", ddec.judge(ctx, torch, dev, cfg, kept))
        if args.control:
            emit("control_fp8", ddec.judge(ctx, torch, dev, cfg, kept,
                                           quant="fp8"))
        if args.faults:
            for got in kept.values():
                rows = got["answers"]
                i = max(range(len(rows)), key=lambda r: len(rows[r]))
                if rows[i]:
                    m = len(rows[i]) // 2
                    rows[i][m] = rows[i][m] % 27 + 1
                else:
                    rows[i].append(1)
            emit("fault_token_altered", ddec.judge(ctx, torch, dev, cfg,
                                                   kept))
            emit("fault_head_scaled", ddec.judge(ctx, torch, dev, cfg,
                                                 kept_scaled))
    finally:
        shutil.rmtree(lm_dir, ignore_errors=True)


def main(argv=None) -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from asrbench import common, judge
    common.cache_env()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if args.tiny:
        torch.set_num_threads(1)
    else:
        common.device_identity(1)
    dev = torch.device("cpu" if args.tiny else "cuda")
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = common.load_ctx(args.workload, seed, 0.0, False, args.tiny,
                              time.perf_counter())
        t0 = time.perf_counter()

        def emit(kind, readings):
            readings = {k: v for k, v in readings.items()
                        if not k.startswith("_")}
            ok, _ = judge.checks(readings, ctx.cell_file["limits"])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "readings": readings,
                              "correct": ok,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        run = _train if ctx.cell_file["driver"] == "train" else _decode
        run(ctx, torch, dev, args, emit)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
