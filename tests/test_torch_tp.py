"""The port's tensor-parallel regime (``ctc_asr_tpu_torch.parallel.tp``) on
the CPU: real OS processes in a gloo group, held against the JAX
reference's ``make_sharded_train_step`` with ``shard_model`` on the
conftest's virtual CPU devices.

- One step at 1 x 2 and 2 x 2 (data x model) on the reference's TP case
  (``tests/test_parallel.py:92-105``: dense frontend and BiLSTM of 512,
  so every wide leaf shards), from the reference's initial state: the
  loss at rtol 1e-4 and every parameter after the step at rtol 2e-4 /
  atol 1e-4; the TP eval step's logits against
  ``make_sharded_eval_step`` at 2e-4.
- The gather's backward is the rank's own slice: a case that a gather
  summing in its backward, as ``torch.distributed.nn.functional.
  all_gather`` does, gets wrong by the factor 'model'.
- The reference's 4-process DP x TP case
  (``tests/test_multiprocess.py:171-196``: a 256-wide dense frontend
  sharded, the narrow LSTM replicated): ``train()`` on four ranks for
  four steps against the reference's 2 x 2 step fed the two data rows'
  loader shards, the ranks of a model group reading the same batches;
  the checkpoint of step 2 resumes bit-identically on every rank, and
  the one of step 4 loads in one process of either package.
- ``param_spec`` against the reference's ``_param_spec`` for every leaf.

Workers are this file run as a script; JAX and the reference are
imported inside the functions that run them, so that a worker imports
torch and the port alone.
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
TIMEOUT_S = 300
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-4
STEPS = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_group(cmds: list) -> None:
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


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _join(args):
    from ctc_asr_tpu_torch.config import MeshConfig, from_json
    from ctc_asr_tpu_torch.parallel import initialize_distributed
    torch.set_num_threads(1)
    with open(args.config) as f:
        cfg = from_json(f.read())
    assert initialize_distributed(MeshConfig(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.world, process_id=args.rank), "cpu")
    return cfg


class _SummingGather(torch.autograd.Function):
    """A gather whose backward sums the gradient over the group before
    taking the rank's slice, as ``torch.distributed.nn.functional.
    all_gather``'s backward does (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        from ctc_asr_tpu_torch.parallel.dist import gather_columns
        import torch.distributed as dist
        ctx.group, ctx.col, ctx.width = group, dist.get_rank(group), \
            x.shape[-1]
        return gather_columns(x, group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        lo = ctx.col * ctx.width
        return g[..., lo:lo + ctx.width], None


def _step_worker(args) -> None:
    """One TP step from the state in ``--init`` on this data row's part of
    the batch in ``--batch``; rank 0 writes the loss and the gathered
    parameters. Every rank also writes the gradient its own columns get
    through ``GatherFromModel`` and through the summing all_gather."""
    import torch.distributed as dist
    from ctc_asr_tpu_torch import checkpoint as ckpt_mod
    from ctc_asr_tpu_torch import train as train_mod
    from ctc_asr_tpu_torch.parallel.dist import (gather_state, grid_groups,
                                                 shard_state)
    from ctc_asr_tpu_torch.parallel.mesh import build_mesh
    from ctc_asr_tpu_torch.parallel.tp import (GatherFromModel,
                                               make_tp_eval_step,
                                               sharded_keys)
    cfg = _join(args)
    try:
        mesh = build_mesh(cfg.mesh)
        groups = grid_groups(mesh)
        sharded = sharded_keys(cfg, mesh)
        with np.load(args.init) as z:
            state = train_mod.state_from_parts(
                cfg, *ckpt_mod.state_from_flat(dict(z), cfg),
                torch.device("cpu"))
        shard_state(state, mesh, sharded)
        with np.load(args.batch) as z:
            arrs = [torch.from_numpy(z[k]) for k in
                    ("samples", "slens", "labels", "llens")]
        per = arrs[0].shape[0] // mesh.data
        arrs = [a[mesh.data_row * per:(mesh.data_row + 1) * per]
                for a in arrs]
        logits, lens = make_tp_eval_step(cfg, mesh, groups)(
            {k: v.detach() for k, v in state["params"].items()}, *arrs[:2])
        np.savez(args.out + ".eval.npz", logits=logits.numpy(),
                 lens=lens.numpy())
        m = train_mod.make_step_fn(cfg, dist.group.WORLD, mesh, groups)(
            state, *arrs)
        full = gather_state(state, sharded, groups.model)
        # the gather's backward: y = gather(x), L = sum(y * w)
        n, col = mesh.model, mesh.model_col
        w = torch.arange(3 * 4 * n, dtype=torch.float32).reshape(3, 4 * n)
        grads = {}
        for name, gather in (("port", GatherFromModel),
                             ("summing", _SummingGather)):
            x = torch.full((3, 4), float(mesh.rank), requires_grad=True)
            (gather.apply(x, groups.model) * w).sum().backward()
            grads[name] = x.grad.tolist()
        out = {"grads": grads, "want": w[:, col * 4:(col + 1) * 4].tolist(),
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        if mesh.rank == 0:
            np.savez(args.out + ".npz", **{k: v.detach().numpy()
                                            for k, v in full["params"].items()})
        with open(args.out, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _train_worker(args) -> None:
    """``train()`` on this rank, recording each step's loss and batch,
    the full parameters after each step (``eval_fn`` gets them) and what
    ``save_checkpoint`` returned."""
    import torch.distributed as dist
    from ctc_asr_tpu_torch import checkpoint as ckpt_mod
    from ctc_asr_tpu_torch import train as train_mod
    cfg = _join(args)
    rec = {"loss": [], "batches": [], "params": [], "saved": []}
    real_make, real_save = train_mod.make_step_fn, ckpt_mod.save_checkpoint

    def make_step_fn(*a, **k):
        step = real_make(*a, **k)

        def recorded(state, *arrs):
            rec["batches"].append(_digest(arrs))
            return step(state, *arrs)
        return recorded

    def save_checkpoint(*a, **k):
        rec["saved"].append(real_save(*a, **k))
        return rec["saved"][-1]

    class Writer:
        def write(self, step, **scalars):
            if "loss" in scalars:
                rec["loss"].append(scalars["loss"])

        def close(self):
            pass

    def eval_fn(state):
        rec["params"].append(_digest(state["params"][k]
                                     for k in sorted(state["params"])))
        return {}

    train_mod.make_step_fn = make_step_fn
    ckpt_mod.save_checkpoint = save_checkpoint
    try:
        train_mod.train(cfg, "cpu", max_steps=STEPS, eval_fn=eval_fn,
                        writer=Writer())
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(rec, f)


def _worker(argv) -> int:
    ap = argparse.ArgumentParser()
    for k in ("config", "out", "init", "batch", "mode"):
        ap.add_argument(f"--{k}", default="")
    for k in ("rank", "world", "port"):
        ap.add_argument(f"--{k}", type=int, required=True)
    args = ap.parse_args(argv)
    (_step_worker if args.mode == "step" else _train_worker)(args)
    return 0


def _launch(cfg, tmp: str, tag: str, world: int, mode: str,
            extra=()) -> list:
    from ctc_asr_tpu_torch.config import to_json
    path = os.path.join(tmp, f"{tag}.json")
    with open(path, "w") as f:
        f.write(to_json(cfg))
    port = _free_port()
    outs = [os.path.join(tmp, f"{tag}_rank{r}.json") for r in range(world)]
    _run_group([[sys.executable, os.path.abspath(__file__), "--mode", mode,
                 "--config", path, "--rank", str(r), "--world", str(world),
                 "--port", str(port), "--out", outs[r], *extra]
                for r in range(world)])
    recs = []
    for o in outs:
        with open(o) as f:
            recs.append(json.load(f))
    return recs


# ---------------------------------------------------------------------------
# (1) one step at 1 x 2 and 2 x 2 against make_sharded_train_step
# ---------------------------------------------------------------------------

def _tp_cfg(model_axis=2, units=512):
    """``tests/test_parallel.py::_tiny_cfg(shard_model=True, ...)``."""
    from ctc_asr_tpu.config import (Config, DataConfig, FeatureConfig,
                                    MeshConfig, ModelConfig, TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13, n_mels=26,
                               use_pallas=False),
        model=ModelConfig(frontend="dense", dense_layers=1,
                          dense_units=units, rnn_layers=1, rnn_units=units,
                          dropout=0.0, compute_dtype="float32"),
        data=DataConfig(batch_size=8),
        train=TrainConfig(learning_rate=1e-3, seed=0),
        mesh=MeshConfig(shard_model=True, model_axis=model_axis))


def _port_cfg(jcfg):
    from ctc_asr_tpu.config import to_json
    from ctc_asr_tpu_torch.config import from_json
    return from_json(to_json(jcfg))


def _fake_batch(B=8, seconds=0.5, sr=16000, U=4, seed=0):
    rng = np.random.default_rng(seed)
    S = int(seconds * sr)
    return (rng.standard_normal((B, S)).astype(np.float32) * 0.1,
            np.full((B,), S, np.int32),
            rng.integers(0, 28, (B, U)).astype(np.int32),
            np.full((B,), U, np.int32))


@pytest.fixture(scope="module")
def tp_init(tmp_path_factory):
    """The reference's initial state of the TP config as a flat npz, and
    the batch."""
    import jax
    from ctc_asr_tpu.checkpoint import _flatten
    from ctc_asr_tpu.train import init_train_state
    tmp = str(tmp_path_factory.mktemp("tp_step"))
    jcfg = _tp_cfg()
    np.savez(os.path.join(tmp, "init.npz"),
             **_flatten(jax.device_get(init_train_state(jcfg))))
    s, sl, lab, ll = _fake_batch()
    np.savez(os.path.join(tmp, "batch.npz"), samples=s, slens=sl,
             labels=lab, llens=ll)
    return tmp, jcfg


def _jax_tp_step(jcfg, n_devices):
    import jax
    from ctc_asr_tpu.config import MeshConfig
    from ctc_asr_tpu.parallel.dist import make_sharded_train_step
    from ctc_asr_tpu.parallel.mesh import build_mesh
    from ctc_asr_tpu.train import init_train_state
    mesh = build_mesh(MeshConfig(model_axis=2), jax.devices()[:n_devices])
    state = init_train_state(jcfg)
    step = make_sharded_train_step(jcfg, mesh, state, donate=False)
    out, m = step(state, *_fake_batch())
    return float(m["loss"]), jax.device_get(out["params"])


@pytest.fixture(scope="module")
def tp_steps(tp_init):
    """The step workers' records at 1 x 2 and 2 x 2, by world size."""
    tmp, jcfg = tp_init
    return {world: _launch(_port_cfg(jcfg), tmp, f"step{world}", world,
                           "step", ["--init", os.path.join(tmp, "init.npz"),
                                    "--batch", os.path.join(tmp,
                                                            "batch.npz")])
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_tp_step_matches_make_sharded_train_step(tp_init, tp_steps, world):
    from ctc_asr_tpu.checkpoint import _flatten
    tmp, jcfg = tp_init
    recs = tp_steps[world]
    want_loss, want_params = _jax_tp_step(jcfg, world)
    for r in recs:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
    assert len({r["grad_norm"] for r in recs}) == 1
    with np.load(os.path.join(tmp, f"step{world}_rank0.json.npz")) as z:
        got = dict(z)
    want = {k[len("params/"):]: v for k, v in
            _flatten({"params": want_params}).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_tp_eval_step_matches_make_sharded_eval_step(tp_init, tp_steps,
                                                     world):
    """``make_tp_eval_step`` on each rank's data row, from the initial
    state, against the reference's ``make_sharded_eval_step`` with
    ``shard_model``: the logits at the golden 2e-4 (atol 2e-5), the
    lengths equal, and the same rows on the ranks of a model group."""
    import jax
    from ctc_asr_tpu.config import MeshConfig
    from ctc_asr_tpu.parallel.dist import make_sharded_eval_step
    from ctc_asr_tpu.parallel.mesh import build_mesh
    from ctc_asr_tpu.train import init_train_state
    tmp, jcfg = tp_init
    assert tp_steps[world]
    mesh = build_mesh(MeshConfig(model_axis=2), jax.devices()[:world])
    samples, slens, _, _ = _fake_batch()
    want, want_lens = make_sharded_eval_step(jcfg, mesh, shard_model=True)(
        init_train_state(jcfg)["params"], samples, slens)
    want, want_lens = np.asarray(want), np.asarray(want_lens)
    per = len(samples) // (world // 2)
    for r in range(world):
        with np.load(os.path.join(tmp, f"step{world}_rank{r}.json.eval.npz")
                     ) as z:
            rows = slice((r // 2) * per, (r // 2 + 1) * per)
            np.testing.assert_array_equal(z["lens"], want_lens[rows])
            np.testing.assert_allclose(z["logits"], want[rows], rtol=2e-4,
                                       atol=2e-5)


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_gather_backward_is_the_own_slice(tp_steps, world):
    """y = gather(x), L = sum(y * w): dL/dx is w's own columns on every
    rank; the summing all_gather gives 'model' (2) times that, so a
    gather built on it fails here."""
    recs = tp_steps[world]
    for r in recs:
        want = np.asarray(r["want"])
        np.testing.assert_array_equal(r["grads"]["port"], want)
        np.testing.assert_array_equal(r["grads"]["summing"], 2 * want)
    assert recs[0]["want"] != recs[1]["want"]


# ---------------------------------------------------------------------------
# (2) train() on four ranks: the reference's DP x TP case
# ---------------------------------------------------------------------------

def _mp_cfg(manifest, train_dir, checkpoint_every=1):
    """``tests/multiproc_worker.py``'s config with ``--model-axis 2
    --dense-units 256``."""
    from ctc_asr_tpu.config import (Config, DataConfig, FeatureConfig,
                                    MeshConfig, ModelConfig, TrainConfig)
    return Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13,
                               use_pallas=False),
        model=ModelConfig(frontend="dense", dense_layers=1, dense_units=256,
                          rnn_layers=1, rnn_units=32, dropout=0.0,
                          compute_dtype="float32", use_pallas_rnn=False),
        data=DataConfig(train_manifest=manifest, batch_size=2,
                        num_buckets=1, num_workers=1,
                        min_audio_seconds=0.05, max_audio_seconds=10.0),
        train=TrainConfig(learning_rate=3e-3, total_steps=STEPS,
                          use_pallas_ctc=False, train_dir=train_dir,
                          log_every=1, sync_every=1, eval_every=1,
                          checkpoint_every=checkpoint_every),
        mesh=MeshConfig(model_axis=2, shard_model=True))


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """16 utterances; four ranks (2 x 2) train four steps from the
    reference's initial state, a checkpoint after every step."""
    import jax
    from ctc_asr_tpu import checkpoint as jckpt
    from ctc_asr_tpu.data.synth import generate_corpus
    from ctc_asr_tpu.train import init_train_state
    tmp = str(tmp_path_factory.mktemp("tp_run"))
    manifest = generate_corpus(os.path.join(tmp, "corpus"),
                               num_utterances=16, seed=3, min_words=1,
                               max_words=2)
    jcfg = _mp_cfg(manifest, os.path.join(tmp, "run"))
    jckpt.save_checkpoint(jcfg.train.train_dir + "/ckpt", 0,
                          jax.device_get(init_train_state(jcfg)),
                          process_index=0)
    return jcfg, tmp, _launch(_port_cfg(jcfg), tmp, "run", 4, "train")


def _jax_2x2_run(jcfg, steps=STEPS):
    """The reference's 2 x 2 step on 4 virtual devices fed the two data
    rows' loader shards concatenated (its single-process check,
    ``tests/multiproc_worker.py``): the losses, and the state after the
    first step."""
    import jax
    from ctc_asr_tpu.data import DataLoader, read_manifest
    from ctc_asr_tpu.parallel.dist import make_sharded_train_step, shard_tree
    from ctc_asr_tpu.parallel.mesh import (batch_sharding, build_mesh,
                                           state_shardings)
    from ctc_asr_tpu.train import init_train_state
    mesh = build_mesh(jcfg.mesh, jax.devices()[:4])
    state = init_train_state(jcfg)
    step_fn = make_sharded_train_step(jcfg, mesh, state)
    state = shard_tree(mesh, jax.device_get(state),
                       state_shardings(state, mesh, True))
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
            if len(losses) == 1:
                first = jax.device_get(state)
    finally:
        for it in its:
            it.close()
    return losses, first


def test_four_ranks_match_the_reference_2x2_step(tp_run):
    """The losses of four steps; after the first, the Adam moments (mu =
    (1 - b1) g: the averaged gradients) at 2e-4 of each leaf's scale and
    the parameters at rtol 2e-4 / atol 1e-4. Adam's first update is lr *
    g / (|g| + eps): where the reference's |g| is under 1e-6 (within the
    summation order's rounding of 0, against leaf scales of ~1e-1) the
    update is as large as lr whatever g's value, and the parameter is
    held to 2 lr there."""
    from ctc_asr_tpu.checkpoint import _flatten
    jcfg, _, recs = tp_run
    want_losses, first = _jax_2x2_run(jcfg)
    for r in recs:
        np.testing.assert_allclose(r["loss"], want_losses, rtol=LOSS_RTOL)
        assert r["loss"] == recs[0]["loss"]
    want = _flatten(first)
    path = os.path.join(jcfg.train.train_dir, "ckpt", "step_00000001.npz")
    with np.load(path) as z:
        got = dict(z)
    mu = {k.split(".mu/", 1)[1]: k for k in want if ".mu/" in k}
    lr, b1 = jcfg.train.learning_rate, jcfg.train.adam_b1
    n_tiny = 0
    for leaf, mk in mu.items():
        scale = float(np.abs(want[mk]).max())
        np.testing.assert_allclose(got[mk], want[mk], rtol=0,
                                   atol=PARAM_RTOL * scale, err_msg=mk)
        pk = "params/" + leaf
        tiny = np.abs(want[mk] / (1 - b1)) < 1e-6
        n_tiny += int(tiny.sum())
        np.testing.assert_allclose(got[pk][~tiny], want[pk][~tiny],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=pk)
        assert np.all(np.abs(got[pk] - want[pk])[tiny] <= 2 * lr), pk
    assert n_tiny < 1e-3 * sum(v.size for v in want.values())


def test_model_group_ranks_read_the_same_batches(tp_run):
    _, _, recs = tp_run
    assert recs[0]["batches"] == recs[1]["batches"]
    assert recs[2]["batches"] == recs[3]["batches"]
    assert all(a != b for a, b in zip(recs[0]["batches"],
                                      recs[2]["batches"]))
    # every rank holds the same full parameters after every step
    assert len(recs[0]["params"]) == STEPS
    assert all(r["params"] == recs[0]["params"] for r in recs)
    # rank 0 alone wrote the checkpoints
    assert [os.path.basename(p) for p in recs[0]["saved"]] == [
        f"step_{i:08d}.npz" for i in range(1, STEPS + 1)]
    assert all(r["saved"] == [] for r in recs[1:])


def test_tp_checkpoint_resumes_bit_identically_and_loads_in_one_process(
        tp_run):
    import jax
    from ctc_asr_tpu import checkpoint as jckpt
    from ctc_asr_tpu.train import init_train_state
    from ctc_asr_tpu_torch import checkpoint as t_ckpt
    jcfg, tmp, full = tp_run
    part_dir = os.path.join(tmp, "part")
    os.makedirs(part_dir + "/ckpt")
    for ext in (".npz", ".json"):
        shutil.copy(os.path.join(jcfg.train.train_dir, "ckpt",
                                 "step_00000002" + ext), part_dir + "/ckpt")
    cfg = _port_cfg(jcfg)
    part_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, train_dir=part_dir))
    part = _launch(part_cfg, tmp, "part", 4, "train")
    for f, p in zip(full, part):
        assert p["loss"] == f["loss"][2:]
        assert p["params"] == f["params"][2:]
        assert p["batches"] == f["batches"][2:]
    # the checkpoint is the reference's flat format with full leaves: one
    # process of either package loads it
    path = os.path.join(part_dir, "ckpt", "step_00000004.npz")
    params = t_ckpt.load_params(path, cfg, "cpu")
    assert _digest(params[k] for k in sorted(params)) == full[0]["params"][-1]
    jstate, _ = jckpt.load_checkpoint(path, init_train_state(jcfg))
    assert int(jstate["step"]) == STEPS
    wx = np.asarray(jax.device_get(jstate["params"]["frontend"][0]["w"]))
    np.testing.assert_array_equal(wx, params["frontend/0/w"].numpy())


# ---------------------------------------------------------------------------
# (3) the sharding rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["conv_bilstm3", "dense", "gru_dense"])
def test_param_spec_matches_the_reference(name):
    import jax
    from ctc_asr_tpu.config import preset
    from ctc_asr_tpu.parallel.mesh import _param_spec
    from ctc_asr_tpu.train import init_train_state
    from ctc_asr_tpu_torch.parallel.mesh import param_spec
    jcfg = preset("conv_bilstm3") if name == "conv_bilstm3" else \
        _tp_cfg(units=512)
    if name == "gru_dense":
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, rnn_type="gru", rnn_units=96, dense_units=300))
    shapes = jax.eval_shape(lambda: init_train_state(jcfg)["params"])
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    n_sharded = 0
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        for shard in (True, False):
            spec = _param_spec(path, leaf, shard)
            want = None if spec == jax.sharding.PartitionSpec() else \
                list(spec).index("model")
            assert param_spec(key, leaf.shape, shard) == want, (key, shard)
            n_sharded += want is not None
    assert n_sharded == {"conv_bilstm3": 18, "dense": 5,
                         "gru_dense": 5}[name]


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
