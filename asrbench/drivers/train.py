"""Training: ``train.make_step_fn``'s step fed by ``train.device_batches``
(the next batch's pinned upload in flight), as the port's train loop
runs it.

Set-up builds one train state from the seed's parameters, warms each of
the mix's bucket shapes with ``train.precompile_bucket_shapes`` (a zeros
copy of the state), and drives the state through its first three steps
on the stream's first batches; the reference follows those three after
the window. The window then runs whole cycles of the buckets through the
same state, feed and step until ``--seconds`` have passed, fetching the
gradient norm once a cycle as the port's loop does every
``train.sync_every`` steps, and ends on a device synchronisation.

``train_audio_s_per_s`` is the unpadded audio of every step of the
window over the window's wall time.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np

from .. import judge, trace as trace_mod, traffic, weights
from ..common import log
from ..feed import Prefetch

FIRST_STEPS = 3
TRACE_CYCLES = 2        # whole cycles a --trace 1 run traces after the window


def _records(batch) -> dict:
    return {"bucket": batch.bucket_id, "B": len(batch.sample_lengths),
            "S": batch.samples.shape[1], "U": batch.labels.shape[1],
            "lengths": np.asarray(batch.sample_lengths)}


def log_phases(ctx, marks) -> None:
    t = [ctx.t_start] + [m[1] for m in marks]
    log("[set-up] " + ", ".join(f"{name} {b - a:.3f} s" for (name, _), a, b
                                in zip(marks, t, t[1:])))


def setup(ctx, torch, dev):
    """The program's config, stream, train state, step and feed, warmed,
    driven through its first steps: (parts, first-steps snapshot)."""
    from ctc_asr_tpu_torch import config as pconfig
    from ctc_asr_tpu_torch import train as ptrain
    from ctc_asr_tpu_torch.optim import Adam
    marks = [("imports", time.perf_counter())]
    pc = pconfig.from_json(json.dumps(ctx.cfg))
    plan = traffic.plan(ctx.mix, pc.features.win_length,
                        pc.features.hop_length)
    stream = traffic.Stream(plan, ctx.seed)
    marks.append(("traffic", time.perf_counter()))
    params = weights.make_params(ctx.family, ctx.cfg, ctx.seed, dev)
    state = ptrain.state_from_parts(pc, params, Adam(pc.train).init(params),
                                    0, {}, dev)
    del params
    step_fn = ptrain.make_step_fn(pc)
    shapes = SimpleNamespace(
        spec=SimpleNamespace(batch_size=plan.batch_size, buckets=[
            SimpleNamespace(max_samples=b.max_samples,
                            max_label_len=b.max_label_len)
            for b in plan.buckets]),
        cache=None, cfg=SimpleNamespace(wire_dtype=pc.data.wire_dtype))
    marks.append(("weights and state", time.perf_counter()))
    ptrain.precompile_bucket_shapes(step_fn, state, shapes, pc)
    marks.append(("warm-up", time.perf_counter()))
    pre = Prefetch(stream, 0)
    feed = ptrain.device_batches(pre, None, dev)
    losses, mu1 = [], None
    for i in range(FIRST_STEPS):
        batch, arrs = next(feed)
        m = step_fn(state, *arrs)
        losses.append(m["loss"])
        if i == 0:
            mu1 = {k: v.detach().to("cpu", copy=True) for k, v in
                   state["opt_state"]["mu"].items()}
    first = {"losses": [float(v) for v in losses], "mu1": mu1,
             "params": {k: v.detach().to("cpu", copy=True)
                        for k, v in state["params"].items()}}
    marks.append(("first steps", time.perf_counter()))
    log_phases(ctx, marks)
    return SimpleNamespace(pc=pc, plan=plan, stream=stream, state=state,
                           step_fn=step_fn, feed=feed, pre=pre), first


def reference_readings(ctx, torch, dev, first: dict, quant=None,
                       rows=None) -> dict:
    """The reference's first steps from the seed's start, held against
    ``first`` (the program's, or a control's)."""
    plan = traffic.plan(ctx.mix)
    stream = traffic.Stream(plan, ctx.seed)
    batches = []
    for j in range(FIRST_STEPS):
        b = stream.batch(j)
        batches.append({k: torch.as_tensor(np.ascontiguousarray(v),
                                           device=dev)
                        for k, v in (("samples", b.samples),
                                     ("sample_lengths", b.sample_lengths),
                                     ("labels", b.labels),
                                     ("label_lengths", b.label_lengths))})
    params0 = weights.make_params(ctx.family, ctx.cfg, ctx.seed, dev)
    want = ctx.family.train_steps(params0, batches, ctx.cfg, quant=quant,
                                  rows=rows)
    return judge.train_readings(first, want, params0,
                                ctx.cfg["train"]["adam_b1"])


def run(ctx) -> dict:
    import torch
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    parts, first = setup(ctx, torch, dev)
    step_fn, state, feed, cycle = (parts.step_fn, parts.state, parts.feed,
                                   parts.plan.cycle)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    log(f"[train] set-up {setup_s:.3f} s; first losses {first['losses']}")
    records, loss_list = [], []
    while True:
        for _ in range(cycle):
            batch, arrs = next(feed)
            m = step_fn(state, *arrs)
            loss_list.append(m["loss"])
            records.append(_records(batch))
        gn = float(m["grad_norm"])     # the loop's host fetch: a barrier
        if gn != gn or time.perf_counter() - t0 >= ctx.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    audio = sum(float(r["lengths"].sum()) for r in records) \
        / ctx.mix["sample_rate"]
    n_bad = int((~torch.isfinite(torch.stack(loss_list))).sum())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"[train] window {wall:.3f} s, {len(records)} steps, {audio:.1f} "
        f"audio s, peak {peak / 2**30:.2f} GiB")
    out = {"attempted": len(records), "failed": n_bad, "setup_s": setup_s,
           "window_s": wall, "records": records, "memory_peak": peak,
           "cfg": ctx.cfg,
           "e2e": {"train_audio_s_per_s": audio / wall, "setup_s": setup_s}}
    if ctx.trace:
        traced = []

        def cycles():
            for _ in range(TRACE_CYCLES * cycle):
                batch, arrs = next(feed)
                step_fn(state, *arrs)
                traced.append(_records(batch))
        tr = trace_mod.capture(cycles, "asrbench.train_window", cuda)
        tr.records = traced[-TRACE_CYCLES * cycle:]
        tr.steps = len(tr.records)
        out["trace"] = tr
    feed.close()
    parts.pre.close()
    del parts, state, step_fn, feed, loss_list, m
    if cuda:
        torch.cuda.empty_cache()
    readings = reference_readings(ctx, torch, dev, first)
    log(f"[train] judged leaves: {readings.pop('_leaves')}")
    out["readings"] = readings
    return out

