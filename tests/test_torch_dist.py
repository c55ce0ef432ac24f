"""The port's data-parallel regime (``ctc_asr_tpu_torch.parallel``) on the
CPU: real OS processes in a gloo group, held against the JAX reference.

The config is the reference's multi-process one
(``tests/multiproc_worker.py:95-108``): MFCC-13, one dense layer of 32,
one BiLSTM-32, f32, plain paths, B=2 a process, one bucket. The corpus
is 16 synthetic utterances; the shortest is given a transcript too long
for its frames, so one shard holds an infeasible row in the first step,
and the pmean of the shards' means (the reference's) differs from the
mean over the global batch. Workers are this file run as a script (the
training loop with a recording writer) or the port's CLI; each is
started with a timeout, and a case takes a few seconds. JAX and the
reference are imported inside the functions that run them, so that a
worker imports torch and the port alone.

- Two processes take 4 DP steps; the losses match the reference's
  ``make_sharded_train_step`` on a 2-device mesh fed the concatenated
  shards, at the golden tolerance 2e-4, and the ranks' parameters are
  bit-equal after every step; only rank 0 writes checkpoints.
- With dropout and SpecAugment on, a run resumed from process 0's step-2
  checkpoint is bit-identical on both ranks to the uninterrupted run,
  and the ranks' masks differ.
- ``cli train`` and ``cli evaluate`` in two processes: process 0 alone
  writes ``metrics.jsonl`` and the dump, and the eval records are the
  whole corpus in process-major order.
- A DP step at world size 1 (gloo, in this process) is bit-equal to the
  single-process step; the process grid's sizes and refusals.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_TOL = 2e-4
STEPS = 4
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_group(cmds: list) -> list:
    """Start the commands together (one a rank), wait for all with a
    timeout, kill every one if any hangs; returns their outputs."""
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o[-4000:]}"
    return outs


# ---------------------------------------------------------------------------
# the worker: the port's training loop in one rank of a gloo group
# ---------------------------------------------------------------------------

def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _copy(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def _worker(argv) -> int:
    """One rank: ``train()`` under the group it forms, recording each
    step's loss, the parameters after each step, the masks each
    generator would draw on fixed inputs, and what ``save_checkpoint``
    returned."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--broadcast-only", action="store_true",
                    help="perturb rank 1's fresh state, broadcast, record")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from ctc_asr_tpu_torch import checkpoint as ckpt_mod
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.config import MeshConfig, from_json
    from ctc_asr_tpu_torch.parallel import initialize_distributed

    with open(args.config) as f:
        cfg = from_json(f.read())
    assert initialize_distributed(MeshConfig(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.world, process_id=args.rank), "cpu")
    if args.broadcast_only:
        from ctc_asr_tpu_torch.parallel.dist import broadcast_state
        state = train_mod.init_train_state(cfg, "cpu")
        leaves = [*state["params"].values(),
                  *state["opt_state"]["mu"].values(),
                  *state["opt_state"]["nu"].values()]
        with torch.no_grad():
            for t in leaves:
                t.add_(float(args.rank))
        broadcast_state(state, dist.group.WORLD)
        dist.destroy_process_group()
        with open(args.out, "w") as f:
            json.dump({"state": _digest(leaves)}, f)
        return 0
    rec = {"steps": [], "loss": [], "grad_norm": [], "params": [],
           "dropout": [], "specaugment": [], "saved": []}
    real_sa, real_enc = train_mod.spec_augment, train_mod.apply_encoder
    real_save = ckpt_mod.save_checkpoint

    def spec_augment(feats, flens, *a):
        probe = real_sa(torch.ones(feats.shape),
                        torch.full_like(flens, feats.shape[1]), *a[:-1],
                        _copy(a[-1]))
        rec["specaugment"].append(_digest([probe]))
        return real_sa(feats, flens, *a)

    def apply_encoder(*a, generator=None, **k):
        if generator is not None:
            rec["dropout"].append(_digest([torch.rand(
                64, generator=_copy(generator))]))
        return real_enc(*a, generator=generator, **k)

    def save_checkpoint(*a, **k):
        path = real_save(*a, **k)
        rec["saved"].append(path)
        return path

    class Writer:
        def write(self, step, **scalars):
            if "loss" in scalars:
                rec["steps"].append(step)
                rec["loss"].append(scalars["loss"])
                rec["grad_norm"].append(scalars["grad_norm"])

        def close(self):
            pass

    def eval_fn(state):
        rec["params"].append(_digest(state["params"].values()))
        return {}

    train_mod.spec_augment = spec_augment
    train_mod.apply_encoder = apply_encoder
    ckpt_mod.save_checkpoint = save_checkpoint
    try:
        train_mod.train(cfg, "cpu", max_steps=args.steps, eval_fn=eval_fn,
                        writer=Writer())
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(rec, f)
    return 0


def _launch(cfg, tmp, tag, steps=STEPS, world=2, extra=()) -> list:
    """``world`` workers of ``cfg`` (a port config) to ``steps``; their
    records, rank by rank."""
    from ctc_asr_tpu_torch.config import to_json
    path = os.path.join(tmp, f"{tag}.json")
    with open(path, "w") as f:
        f.write(to_json(cfg))
    port = _free_port()
    outs = [os.path.join(tmp, f"{tag}_rank{r}.json") for r in range(world)]
    _run_group([[sys.executable, os.path.abspath(__file__), "--config",
                 path, "--rank", str(r), "--world", str(world), "--port",
                 str(port), "--steps", str(steps), "--out", outs[r], *extra]
                for r in range(world)])
    recs = []
    for o in outs:
        with open(o) as f:
            recs.append(json.load(f))
    return recs


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _jax_cfg(manifest, train_dir="", dropout=0.0, specaugment=False,
             checkpoint_every=2):
    from ctc_asr_tpu.config import (Config, DataConfig, FeatureConfig,
                                    ModelConfig, TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13,
                               use_pallas=False),
        model=ModelConfig(frontend="dense", dense_layers=1, dense_units=32,
                          rnn_layers=1, rnn_units=32, dropout=dropout,
                          compute_dtype="float32", use_pallas_rnn=False),
        data=DataConfig(train_manifest=manifest, eval_manifest=manifest,
                        batch_size=2, num_buckets=1, num_workers=1,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=3e-3, total_steps=STEPS,
                          use_pallas_ctc=False, train_dir=train_dir,
                          log_every=1, sync_every=1, eval_every=1,
                          checkpoint_every=checkpoint_every,
                          specaugment=specaugment))


def _port_cfg(jcfg):
    from ctc_asr_tpu.config import to_json
    from ctc_asr_tpu_torch.config import from_json
    return from_json(to_json(jcfg))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 utterances (8 a shard); the shortest one's transcript is made
    infeasible: more labels than its frames."""
    from ctc_asr_tpu_torch.data import read_manifest
    from ctc_asr_tpu_torch.data.synth import generate_corpus
    d = tmp_path_factory.mktemp("dp_corpus")
    path = generate_corpus(str(d), num_utterances=16, seed=3, min_words=1,
                           max_words=2)
    utts = list(read_manifest(path))
    short = min(range(len(utts)), key=lambda i: utts[i].duration)
    n = int(utts[short].duration * 100) + 40          # 10 ms frames
    text = ("abc " * n)[:n].strip()
    with open(path) as f:
        lines = f.read().splitlines()
    cols = lines[short].split(";")
    lines[short] = ";".join(cols[:2] + [text])
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path, short


def _jax_dp_losses(jcfg, steps=STEPS) -> list:
    """The reference's DP step on a 2-device mesh fed the two loader
    shards concatenated (the reference's own single-process check,
    ``tests/multiproc_worker.py``), from its initial state (the one
    ``_save_jax_init`` writes for the workers)."""
    import jax
    from ctc_asr_tpu.config import MeshConfig
    from ctc_asr_tpu.data import DataLoader, read_manifest
    from ctc_asr_tpu.parallel.dist import make_sharded_train_step, shard_tree
    from ctc_asr_tpu.parallel.mesh import (batch_sharding, build_mesh,
                                           state_shardings)
    from ctc_asr_tpu.train import init_train_state
    mesh = build_mesh(MeshConfig(data_axis=2), jax.devices()[:2])
    state = init_train_state(jcfg)
    step_fn = make_sharded_train_step(jcfg, mesh, state)
    state = shard_tree(mesh, jax.device_get(state),
                       state_shardings(state, mesh, False))
    manifest = read_manifest(jcfg.data.train_manifest)
    its = [iter(DataLoader(manifest, jcfg.data, jcfg.features,
                           shard_idx=s, num_shards=2)) for s in range(2)]
    losses = []
    try:
        for _ in range(steps):
            bs = [next(it) for it in its]
            arrs = tuple(jax.device_put(
                np.concatenate([getattr(b, f) for b in bs]),
                batch_sharding(mesh)) for f in (
                    "samples", "sample_lengths", "labels", "label_lengths"))
            state, m = step_fn(state, *arrs)
            losses.append(float(m["loss"]))
    finally:
        for it in its:
            it.close()
    return losses


def _save_jax_init(jcfg) -> None:
    import jax
    from ctc_asr_tpu import checkpoint as jckpt
    from ctc_asr_tpu.train import init_train_state
    jckpt.save_checkpoint(jcfg.train.train_dir + "/ckpt", 0,
                          jax.device_get(init_train_state(jcfg)),
                          process_index=0)


@pytest.fixture(scope="module")
def dp_run(corpus, tmp_path_factory):
    """Two ranks, 4 steps from the reference's initial state (dropout 0,
    SpecAugment off), checkpoints at steps 2 and 4."""
    tmp = str(tmp_path_factory.mktemp("dp_run"))
    jcfg = _jax_cfg(corpus[0], train_dir=os.path.join(tmp, "run"))
    _save_jax_init(jcfg)
    recs = _launch(_port_cfg(jcfg), tmp, "run")
    return jcfg, recs


# ---------------------------------------------------------------------------
# (1), (2): losses against the reference, ranks bit-equal, rank 0 writes
# ---------------------------------------------------------------------------

def _first_step_nll(jcfg, path):
    """Per-row CTC NLL of each shard's first batch at the initial state
    (the port's plain path): [shard 0 rows, shard 1 rows]."""
    from ctc_asr_tpu.checkpoint import _flatten
    from ctc_asr_tpu.train import init_train_state
    from ctc_asr_tpu_torch import checkpoint as t_ckpt
    from ctc_asr_tpu_torch.data import DataLoader, read_manifest
    from ctc_asr_tpu_torch.features import extract_features
    from ctc_asr_tpu_torch.models import apply_encoder
    from ctc_asr_tpu_torch.ops.ctc_cuda import ctc_nll
    cfg = _port_cfg(jcfg)
    params = t_ckpt.params_from_jax(_flatten(init_train_state(jcfg)))
    out = []
    for s in range(2):
        b = next(DataLoader(read_manifest(path), cfg.data, cfg.features,
                            shard_idx=s, num_shards=2).iter_epoch(0))
        x = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            b.samples, b.sample_lengths, b.labels, b.label_lengths)]
        with torch.no_grad():
            feats, flens = extract_features(x[0], x[1], cfg.features)
            logits, lens = apply_encoder(params, feats, flens, cfg.model)
            out.append(ctc_nll(logits, lens, x[2], x[3]).numpy())
    return out


def test_two_process_losses_match_reference_dp_step(corpus, dp_run):
    jcfg, recs = dp_run
    want = _jax_dp_losses(jcfg)
    for r in recs:
        assert r["steps"] == list(range(1, STEPS + 1))
        np.testing.assert_allclose(r["loss"], want, rtol=GOLDEN_TOL)
    # step 1 holds the infeasible row: the pmean of the shards' means is
    # what both packages take, and it is not the batch's finite mean
    nll = _first_step_nll(jcfg, corpus[0])
    assert sum(int(np.isinf(n).sum()) for n in nll) == 1
    pmean = np.mean([n[np.isfinite(n)].mean() for n in nll])
    rows = np.concatenate(nll)
    global_mean = rows[np.isfinite(rows)].mean()
    np.testing.assert_allclose(want[0], pmean, rtol=GOLDEN_TOL)
    assert abs(global_mean / pmean - 1) > 20 * GOLDEN_TOL


def test_two_process_ranks_bit_equal_and_rank1_writes_nothing(dp_run):
    jcfg, (r0, r1) = dp_run
    assert len(r0["params"]) == STEPS
    assert r0["params"] == r1["params"]
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    ckpt = os.path.join(jcfg.train.train_dir, "ckpt")
    assert [os.path.basename(p) for p in r0["saved"]] == [
        "step_00000002.npz", "step_00000004.npz"]
    assert r1["saved"] == []
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".npz")) == [
        "step_00000000.npz", "step_00000002.npz", "step_00000004.npz"]


def test_broadcast_state_starts_the_replicas_equal(corpus, tmp_path):
    """Rank 1's parameters and moments, made to differ, become rank 0's."""
    from ctc_asr_tpu_torch import train as t_train
    cfg = _port_cfg(_jax_cfg(corpus[0]))
    r0, r1 = _launch(cfg, str(tmp_path), "bcast", extra=["--broadcast-only"])
    state = t_train.init_train_state(cfg, "cpu")
    want = _digest([*state["params"].values(),
                    *state["opt_state"]["mu"].values(),
                    *state["opt_state"]["nu"].values()])
    assert r0["state"] == r1["state"] == want


# ---------------------------------------------------------------------------
# (3): resume with dropout and SpecAugment on
# ---------------------------------------------------------------------------

def test_resume_with_dropout_and_specaugment_is_bit_identical(corpus,
                                                              tmp_path):
    tmp = str(tmp_path)
    full_dir, part_dir = (os.path.join(tmp, d) for d in ("full", "part"))
    jcfg = _jax_cfg(corpus[0], train_dir=full_dir, dropout=0.1,
                    specaugment=True)
    _save_jax_init(jcfg)
    full = _launch(_port_cfg(jcfg), tmp, "full")
    os.makedirs(part_dir + "/ckpt")
    for ext in (".npz", ".json"):
        shutil.copy(f"{full_dir}/ckpt/step_00000002{ext}", f"{part_dir}/ckpt")
    part_cfg = _port_cfg(dataclasses.replace(
        jcfg, train=dataclasses.replace(jcfg.train, train_dir=part_dir)))
    part = _launch(part_cfg, tmp, "part")
    for f, p in zip(full, part):
        assert p["steps"] == [3, 4]
        assert p["loss"] == f["loss"][2:]
        assert p["grad_norm"] == f["grad_norm"][2:]
        assert p["params"] == f["params"][2:]
        assert p["dropout"] == f["dropout"][2:]
        assert p["specaugment"] == f["specaugment"][2:]
    assert full[0]["params"] == full[1]["params"]
    for name in ("dropout", "specaugment"):
        assert len(full[0][name]) == STEPS
        assert all(a != b for a, b in zip(full[0][name], full[1][name]))
        assert len(set(full[0][name])) == STEPS      # a new draw a step


# ---------------------------------------------------------------------------
# (4), (5): the CLI in two processes
# ---------------------------------------------------------------------------

def _cli(cmd, cfg_path, world, extra=(), per_rank=lambda r: []):
    port = _free_port()
    mesh = (lambda r: [f"--mesh.coordinator_address=127.0.0.1:{port}",
                       f"--mesh.num_processes={world}",
                       f"--mesh.process_id={r}"]) if world > 1 else \
        (lambda r: [])
    return _run_group([[sys.executable, "-m", "ctc_asr_tpu_torch.cli", cmd,
                        "--config", cfg_path, "--device=cpu", *extra,
                        *mesh(r), *per_rank(r)] for r in range(world)])


def _write_cfg(cfg, path) -> str:
    from ctc_asr_tpu_torch.config import to_json
    with open(path, "w") as f:
        f.write(to_json(cfg))
    return path


def test_cli_train_two_processes_with_eval(corpus, tmp_path):
    train_dir = str(tmp_path / "cli")
    jcfg = _jax_cfg(corpus[0], train_dir=train_dir, checkpoint_every=3)
    cfg = _port_cfg(dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, total_steps=3, eval_every=3)))
    outs = _cli("train", _write_cfg(cfg, str(tmp_path / "c.json")), 2)
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    # one line a step and one eval line: process 0 alone wrote the file
    assert [m["step"] for m in metrics if "loss" in m] == [1, 2, 3]
    evals = [m for m in metrics if "eval_wer" in m]
    assert len(evals) == 1 and evals[0]["eval_utterances"] == 16
    assert os.listdir(os.path.join(train_dir, "ckpt")) and os.path.exists(
        os.path.join(train_dir, "ckpt", "step_00000003.npz"))
    assert all("done at step 3" in o for o in outs)


def test_cli_evaluate_two_processes_process_major(corpus, tmp_path):
    from ctc_asr_tpu_torch import checkpoint as t_ckpt
    from ctc_asr_tpu_torch import train as t_train
    from ctc_asr_tpu_torch.data import DataLoader, read_manifest
    from ctc_asr_tpu_torch.evaluate import evaluate
    cfg = _port_cfg(_jax_cfg(corpus[0]))
    state = t_train.init_train_state(cfg, "cpu")
    ckpt = t_ckpt.save_checkpoint(str(tmp_path / "ckpt"), 1,
                                  t_train.state_to_flat(cfg, state))
    path = _write_cfg(cfg, str(tmp_path / "c.json"))

    def run(world, tag):
        outs = _cli("evaluate", path, world, ["--ckpt", ckpt],
                    lambda r: ["--dump-utts", str(tmp_path / f"{tag}{r}.json")])
        summary = json.loads(outs[0][outs[0].index("{"):
                                     outs[0].rindex("}") + 1])
        with open(tmp_path / f"{tag}0.json") as f:
            return summary, json.load(f)["per_utt"]

    s1, d1 = run(1, "one")
    s2, d2 = run(2, "two")
    assert not os.path.exists(tmp_path / "two1.json")
    assert s1["utterances"] == s2["utterances"] == len(d2) == 16
    for k in ("wer", "cer", "word_edits", "word_count"):
        assert s2[k] == s1[k], k
    assert sorted(map(tuple, d2)) == sorted(map(tuple, d1))
    # process-major: rank 0's shard in its own order, then rank 1's
    params = {k: v.detach() for k, v in state["params"].items()}
    want = []
    for r in range(2):
        ld = DataLoader(read_manifest(corpus[0]), cfg.data, cfg.features,
                        shard_idx=r, num_shards=2, drop_last=False)
        with torch.no_grad():
            want += evaluate(cfg, params, "cpu", loader=ld,
                             log_samples=0)["per_utt"]
    assert [tuple(r) for r in d2] == [tuple(r) for r in want]


# ---------------------------------------------------------------------------
# (6): world size 1, in this process
# ---------------------------------------------------------------------------

def test_dp_step_at_world_one_is_the_single_process_step(corpus):
    """dropout and SpecAugment on: at world size 1 the generators keep
    the single-process stream, and the one-rank all_reduce and the
    division by 1 change no bit."""
    import torch.distributed as dist
    from ctc_asr_tpu_torch import train as t_train
    from ctc_asr_tpu_torch.data import DataLoader, read_manifest
    cfg = _port_cfg(_jax_cfg(corpus[0], dropout=0.1, specaugment=True))
    batch = next(DataLoader(read_manifest(corpus[0]), cfg.data,
                            cfg.features).iter_epoch(0))
    arrs = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        batch.samples, batch.sample_lengths, batch.labels,
        batch.label_lengths)]
    runs = []
    for dp in (False, True):
        state = t_train.init_train_state(cfg, "cpu")
        if dp:
            dist.init_process_group("gloo", store=dist.HashStore(),
                                    world_size=1, rank=0)
        try:
            step = t_train.make_step_fn(
                cfg, dist.group.WORLD if dp else None)
            ms = [step(state, *arrs) for _ in range(2)]
        finally:
            if dp:
                dist.destroy_process_group()
        runs.append((ms, state))
    (m1, s1), (m2, s2) = runs
    for a, b in zip(m1, m2):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    for k in s1["params"]:
        assert torch.equal(s1["params"][k], s2["params"][k]), k
        for part in ("mu", "nu"):
            assert torch.equal(s1["opt_state"][part][k],
                               s2["opt_state"][part][k]), k


# ---------------------------------------------------------------------------
# (7): the process grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,world,want", [
    (dict(), 1, 1), (dict(), 4, 4), (dict(data_axis=4), 4, 4),
    (dict(data_axis=2), 4, "mesh 2x1 != 4 devices"),
    (dict(model_axis=3), 4, "4 devices not divisible by model axis 3"),
    # the regimes of ROADMAP.md A8, under the ids they had when the port
    # refused them all: now built, or refused as the reference refuses
    pytest.param(dict(model_axis=2, shard_model=True), 4, 2,
                 id="mesh5-4-A8"),
    pytest.param(dict(shard_model=True), 2, 2, id="mesh6-2-A8"),
    pytest.param(dict(seq_axis=2), 2,
                 "seq_axis=2 is not supported with multi-process",
                 id="mesh7-2-A8"),
    (dict(num_processes=2), 1, "no.*is formed"),
    (dict(num_processes=4), 2, "has 2"),
])
def test_build_mesh_sizes_and_refusals(mesh, world, want):
    """The grid's sizes, and what the reference refuses: a model axis
    that does not divide the processes, a mesh that does not tile them,
    sequence parallelism with more than one process. Under a model axis
    the ranks of one data row read the same loader shard."""
    from ctc_asr_tpu_torch.config import MeshConfig
    from ctc_asr_tpu_torch.parallel import build_mesh, loader_shard
    cfg = MeshConfig(**mesh)
    if isinstance(want, int):
        model = max(1, cfg.model_axis)
        for rank in range(world):
            m = build_mesh(cfg, world, rank)
            assert (m.data, m.model) == (want, model)
            assert loader_shard(m) == (rank // model, want)
            assert m.tensor_parallel == (cfg.shard_model and model > 1)
        return
    err = RuntimeError if "formed" in want or "has" in want else ValueError
    with pytest.raises(err, match=want):
        build_mesh(cfg, world, 0)


def test_initialize_distributed_is_a_noop_without_processes():
    from ctc_asr_tpu_torch.config import MeshConfig
    from ctc_asr_tpu_torch.parallel import initialize_distributed
    from ctc_asr_tpu_torch.parallel.mesh import process_world
    for cfg in (MeshConfig(), MeshConfig(coordinator_address="localhost:1"),
                MeshConfig(num_processes=2)):
        assert initialize_distributed(cfg, "cpu") is False
    assert process_world() == (1, 0)


def test_save_checkpoint_writes_on_process_zero_only(tmp_path):
    from ctc_asr_tpu_torch import checkpoint as t_ckpt
    flat = {"step": np.asarray(1, np.int32)}
    assert t_ckpt.save_checkpoint(str(tmp_path / "a"), 1, flat,
                                  process_index=1) is None
    assert not os.path.exists(tmp_path / "a")
    assert t_ckpt.save_checkpoint(str(tmp_path / "a"), 1, flat).endswith(
        "step_00000001.npz")


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
