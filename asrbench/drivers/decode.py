"""Decoding: ``evaluate.make_eval_step`` (features, encoder logits), then
``evaluate.make_nbest_decoder`` (K8 with char-LM fusion, the word-LM
rescoring ``pick_best`` on the host) or ``evaluate.make_decoder``
(greedy), fed by ``train.device_batches`` and turned into text by
``text.decode_ids``: the loop of ``evaluate.evaluate``, without its WER.

Set-up makes the parameters from the seed (the output layer shaped by
the configuration's ``assumed.decode_posteriors``), the LMs from the
mix's seeded text (``lmbuild``, into a directory under ``TMPDIR``), and
runs one batch of each bucket through the whole path. The window then
decodes fresh batches in whole cycles until ``--seconds`` have passed.

- ``decode_audio_s_per_s``: the unpadded audio of every batch whose
  texts reached the host, over the window's wall time.
- ``decode_batch_p95_ms``: the 95th percentile over the window's batches
  of the time from the moment a batch's host samples are handed to the
  port's feed to the moment its texts are on the host.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from ..feed import Prefetch
from .. import lmbuild, trace as trace_mod, traffic, weights
from ..common import log
from .train import TRACE_CYCLES, log_phases


def _records(batch) -> dict:
    return {"bucket": batch.bucket_id, "B": len(batch.sample_lengths),
            "S": batch.samples.shape[1],
            "lengths": np.asarray(batch.sample_lengths)}


def win_hop(cfg: dict) -> tuple[int, int]:
    f = cfg["features"]
    return (int(f["sample_rate"] * f["win_ms"] / 1000.0),
            int(f["sample_rate"] * f["hop_ms"] / 1000.0))


def is_fusion(cfg: dict) -> bool:
    return cfg["decode"]["method"] == "beam"


def decode_params(ctx, stream, torch, dev) -> dict:
    """The seed's parameters shaped as a trained model's output is: the
    family's ``shape_for_decode`` (conv_bilstm: each LSTM driven mostly by
    its input, so that posteriors change from frame to frame), then the
    output layer scaled and centred so that on a calibration batch
    (``calibration`` rows x seconds of the stream's audio, through the
    family's reference in f32) the logits' spread over time is
    ``logit_std`` and blank wins a ``blank_share`` of the frames. Random
    weights otherwise give near-uniform posteriors that drift over
    seconds, and a beam with little to merge. Made by the benchmark and
    handed to both sides."""
    fam, cfg = ctx.family, ctx.cfg
    shp = ctx.config_file["assumed"]["decode_posteriors"]
    params = weights.make_params(fam, cfg, ctx.seed, dev)
    fam.shape_for_decode(params, shp, cfg)
    rows, seconds = shp["calibration"]
    audio = torch.as_tensor(stream.calibration(rows, seconds), device=dev)
    lens = torch.full((rows,), audio.shape[1], device=dev)
    with torch.no_grad():
        logits, olens = fam.logits(params, audio, lens, cfg)
        valid = torch.arange(logits.shape[1], device=dev)[None] \
            < olens[:, None]
        x = logits[valid]                               # [frames, C]
        mu = x.mean(0)
        scale = shp["logit_std"] / float((x - mu).std())
        y = (x - mu) * scale
        margin = y[:, :-1].max(-1).values - y[:, -1]
        params["head/w"].mul_(scale)
        params["head/b"].copy_(-scale * mu + params["head/b"] * scale)
        params["head/b"][-1] += float(torch.quantile(
            margin, shp["blank_share"]))
    return params


def setup(ctx, torch, dev, lm_dir: str):
    """The program's decode path from the seed: (parts, config dict as
    run)."""
    from ctc_asr_tpu_torch import config as pconfig
    from ctc_asr_tpu_torch import evaluate as peval
    marks = [("imports", time.perf_counter())]
    cfg = json.loads(json.dumps(ctx.cfg))
    plan = traffic.plan(ctx.mix, *win_hop(cfg))
    stream = traffic.Stream(plan, ctx.seed)
    marks.append(("traffic", time.perf_counter()))
    if is_fusion(cfg):
        lms = ctx.config_file["assumed"]["lms"]
        cfg["decode"]["lm_path"] = os.path.join(lm_dir, "char_lm.npz")
        cfg["decode"]["word_lm_path"] = os.path.join(lm_dir, "word_lm.pkl")
        lmbuild.write_lms(traffic.lm_corpus(stream), lms["char_order"],
                          lms["word_order"], cfg["decode"]["lm_path"],
                          cfg["decode"]["word_lm_path"])
    elif cfg["decode"]["method"] != "greedy":
        raise ValueError(f"unknown decode method {cfg['decode']['method']!r}")
    marks.append(("LMs", time.perf_counter()))
    pc = pconfig.from_json(json.dumps(cfg))
    params = decode_params(ctx, stream, torch, dev)
    eval_step = peval.make_eval_step(pc, dev)
    if is_fusion(cfg):
        decode, pick_best = peval.make_nbest_decoder(pc)
    else:
        decode, pick_best = peval.make_decoder(pc), None
    marks.append(("weights", time.perf_counter()))
    return SimpleNamespace(pc=pc, plan=plan, stream=stream, params=params,
                           eval_step=eval_step, decode=decode,
                           pick_best=pick_best, marks=marks), cfg


def batch_loop(parts, torch, dev, first: int, n: int | None, cuda: bool,
               on_done=None, stop=None) -> int:
    """Decode stream batches from ``first`` on through the port's path,
    ``n`` of them or, with ``stop``, whole cycles until ``stop()`` is
    true at a cycle's start; calls ``on_done(batch, ids, lens, texts,
    handed_s, rescore_s, logits, logit_lens)`` as each batch's texts
    reach the host. Returns the index after the last batch."""
    from ctc_asr_tpu_torch.text import decode_ids
    from ctc_asr_tpu_torch.train import device_batches
    from torch.profiler import record_function
    handed = {}

    end = [first]
    pre = Prefetch(parts.stream, first)

    def src():
        j = first
        while (n is None or j < first + n) and not (
                stop is not None and j > first
                and j % parts.plan.cycle == 0 and stop()):
            b = next(pre)
            handed[j] = time.perf_counter()
            yield b
            j += 1
            end[0] = j

    feed = device_batches(src(), None, dev, with_labels=False)
    try:
        while True:
            with record_function("asrbench.feed"):
                item = next(feed, None)
            if item is None:
                break
            batch, (d_s, d_l) = item
            logits, llens = parts.eval_step(parts.params, d_s, d_l)
            rescore = 0.0
            if parts.pick_best is not None:
                nbest = parts.decode(logits, llens)
                if cuda:
                    torch.cuda.current_stream(dev).synchronize()
                t_r = time.perf_counter()
                with record_function("asrbench.pick_best"):
                    ids, lens = parts.pick_best(*nbest)
                rescore = time.perf_counter() - t_r
            else:
                ids, lens = parts.decode(logits, llens)
                ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            with record_function("asrbench.texts"):
                texts = [decode_ids(ids[i, :lens[i]])
                         for i in range(batch.valid)]
            if on_done is not None:
                on_done(batch, ids, lens, texts, handed.pop(batch.index),
                        rescore, logits, llens)
    finally:
        feed.close()
        pre.close()
    return end[0]


def run(ctx) -> dict:
    import torch
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    lm_dir = tempfile.mkdtemp(prefix="asrbench-lm-",
                              dir=os.environ.get("TMPDIR"))
    try:
        return _run(ctx, torch, dev, cuda, lm_dir)
    finally:
        shutil.rmtree(lm_dir, ignore_errors=True)


def _run(ctx, torch, dev, cuda, lm_dir) -> dict:
    parts, cfg = setup(ctx, torch, dev, lm_dir)
    cycle = parts.plan.cycle
    batch_loop(parts, torch, dev, 0, cycle, cuda)     # every bucket's shape
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    parts.marks.append(("warm-up", time.perf_counter()))
    log_phases(ctx, parts.marks)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    log(f"[decode] set-up {setup_s:.3f} s")
    done = SimpleNamespace(records=[], lat=[], rescore=[], kept={},
                           texts=0)
    judged = set(sample_batches(ctx, parts.plan,
                                range(cycle, 2 * cycle)))

    def on_done(batch, ids, lens, texts, handed, rescore, logits, llens):
        done.lat.append(time.perf_counter() - handed)
        done.rescore.append(rescore)
        done.records.append(_records(batch))
        done.texts += len(texts)
        if batch.index in judged:       # what the judge reads, kept as is
            done.kept[batch.index] = keep(ids, lens, batch.valid, logits,
                                          llens)

    j = batch_loop(parts, torch, dev, cycle, None, cuda, on_done,
                   stop=lambda: time.perf_counter() - t0 >= ctx.seconds)
    wall = time.perf_counter() - t0
    audio = sum(float(r["lengths"].sum()) for r in done.records) \
        / ctx.mix["sample_rate"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    lat = sorted(done.lat)
    p95 = statistics.quantiles(lat, n=100, method="inclusive")[94] \
        if len(lat) > 1 else lat[0]
    log(f"[decode] window {wall:.3f} s, {len(lat)} batches (the p95 is "
        f"over these), {done.texts} texts, {audio:.1f} audio s, median "
        f"batch {statistics.median(lat) * 1e3:.2f} ms, rescoring "
        f"{1e3 * sum(done.rescore) / len(lat):.2f} ms a batch, peak "
        f"{peak / 2**30:.2f} GiB")
    out = {"attempted": sum(r["B"] for r in done.records),
           "failed": sum(r["B"] for r in done.records) - done.texts,
           "setup_s": setup_s, "window_s": wall, "records": done.records,
           "rescore_ms": [1e3 * r for r in done.rescore], "cfg": cfg,
           "memory_peak": peak,
           "e2e": {"decode_audio_s_per_s": audio / wall,
                   "decode_batch_p95_ms": 1e3 * p95, "setup_s": setup_s}}
    if ctx.trace:
        n_tr = TRACE_CYCLES * cycle
        traced = []

        def cycles():
            traced.clear()
            batch_loop(parts, torch, dev, j, n_tr, cuda,
                       lambda b, *a: traced.append(_records(b)))
        tr = trace_mod.capture(cycles, "asrbench.decode_window", cuda)
        tr.records, tr.steps = list(traced), len(traced)
        out["trace"] = tr
        out["lm_table_bytes"] = _lm_table_bytes(cfg)
    del parts
    if cuda:
        torch.cuda.empty_cache()
    out["readings"] = judge(ctx, torch, dev, cfg, done.kept)
    return out


def keep(ids, lens, valid: int, logits, llens) -> dict:
    """One judged batch: its answers (label ids a row) and the eval step's
    output it was decoded from."""
    return {"answers": [[int(c) for c in ids[i, :lens[i]]]
                        for i in range(valid)],
            "logits": logits, "lens": llens}


def _lm_table_bytes(cfg: dict) -> int:
    if not is_fusion(cfg):
        return 0
    with np.load(cfg["decode"]["lm_path"]) as z:
        n_ctx = z["table"].shape[0]
    return 4 * n_ctx * (cfg["model"]["num_classes"] - 1)


def sample_batches(ctx, plan, indices) -> list:
    """The batches the judge reads, drawn from the seed among ``indices``
    (the window's first cycle, which every window finishes): the longest
    bucket's and ``judge_batches - 1`` others."""
    rng = np.random.default_rng(traffic.sub_seed(ctx.seed, 20))
    indices = sorted(indices)
    longest = max(range(len(plan.buckets)),
                  key=lambda b: plan.buckets[b].max_samples)
    pos = plan.order.index(longest)
    pick = [j for j in indices if j % plan.cycle == pos][:1]
    rest = [j for j in indices if j not in pick]
    k = min(ctx.cell_file["judge_batches"] - 1, len(rest))
    return pick + [int(x) for x in rng.choice(rest, k, replace=False)]


def max_decode_len(cfg: dict) -> int:
    d = cfg["decode"]
    if d["max_decode_len"]:
        return int(d["max_decode_len"])
    return max(8, int(np.ceil(cfg["data"]["max_audio_seconds"] * 16.0)))


def judge(ctx, torch, dev, cfg: dict, kept: dict, quant=None) -> dict:
    """The decode cell's numbers over the judged batches ``kept`` (see
    ``judge.py``):

    - ``frame_gap``: at every valid frame, how far the reference's
      log-posterior of the program's top class lies below the
      reference's best (the features, frontend, recurrences and head in
      the program's precision against f32);
    - ``dist_gap``: the largest total-variation distance, over the valid
      frames, between the program's posterior and the reference's, so
      that a head or a softmax that is scaled wrong but keeps each
      frame's top class is caught too (the beam reads the whole
      distribution);
    - ``answer_gap``: how far each answer's decode objective lies below
      that of the reference's own decode of the same posteriors, the
      program's (greedy, or beam with fusion and rescoring: K8, the LMs
      and ``pick_best`` against the frozen plain versions).

    With ``quant`` the reference in that precision stands in the
    program's place (the control): its posteriors and its own answers."""
    from ..reference import decode as dref
    plan = traffic.plan(ctx.mix, *win_hop(cfg))
    stream = traffic.Stream(plan, ctx.seed)
    params = decode_params(ctx, stream, torch, dev)
    lms = None
    if is_fusion(cfg):
        lms = (dref.load_char_lm(cfg["decode"]["lm_path"]),
               dref.load_word_lm(cfg["decode"]["word_lm_path"]))
    frame, dist, answer, blank = [], [], [], []
    for j, got in sorted(kept.items()):
        b = stream.batch(j)
        batch = {"samples": torch.as_tensor(np.ascontiguousarray(b.samples),
                                            device=dev),
                 "sample_lengths": torch.as_tensor(b.sample_lengths,
                                                   device=dev)}
        lp, lens = ctx.family.log_probs(params, batch, cfg)
        if quant is not None:
            lq, _ = ctx.family.log_probs(params, batch, cfg, quant)
            got = {"answers": decide(lq, lens, cfg, lms), "logits": lq,
                   "lens": lens}
        lp_prog = torch.log_softmax(got["logits"].float(), -1)
        if not torch.equal(got["lens"].to(dev).long(), lens.long()):
            raise AssertionError("the program's output lengths differ from "
                                 "the reference's")
        valid = torch.arange(lp.shape[1], device=dev)[None] < lens[:, None]
        top = lp_prog.argmax(-1, keepdim=True)
        gap = (lp.max(-1).values - lp.gather(-1, top)[..., 0]) * valid
        frame.append(float(gap.max()))
        tv = 0.5 * (lp_prog.exp() - lp.exp()).abs().sum(-1) * valid
        dist.append(float(tv.max()))
        blank.append(float(((lp.argmax(-1) == lp.shape[-1] - 1) & valid).sum()
                           / valid.sum()))
        rows = got["answers"]
        if lms is None:
            g = dref.viterbi_gap(lp_prog, lens, rows)
        else:
            best = dref.fusion_answers(lp_prog, lens, *lms, cfg["decode"],
                                       max_decode_len(cfg))
            g = np.maximum(0.0, dref.fusion_scores(lp_prog, lens, best, *lms,
                                                    cfg["decode"])
                           - dref.fusion_scores(lp_prog, lens, rows, *lms,
                                                cfg["decode"]))
        answer.append(float(np.max(g)))
    log(f"[decode] judged batches {sorted(kept)}: frame gaps {frame}, "
        f"largest distances {dist}, answer gaps "
        f"{answer}; the reference's blank argmax share {blank}")
    return {"frame_gap": max(frame), "dist_gap": max(dist),
            "answer_gap": max(answer)}


def decide(lp, lens, cfg: dict, lms) -> list:
    """The reference's own answers from log-posteriors ``lp``: greedy,
    or beam with fusion and rescoring."""
    from ..reference import decode as dref
    if lms is not None:
        return dref.fusion_answers(lp, lens, *lms, cfg["decode"],
                                   max_decode_len(cfg))
    ids = lp.argmax(-1).cpu().numpy()
    out = []
    for row, n in zip(ids, lens.cpu().numpy()):
        path = row[:n]
        keep = [int(c) for i, c in enumerate(path)
                if c != lp.shape[-1] - 1 and (i == 0 or c != path[i - 1])]
        out.append(keep)
    return out

