"""A run of the port reproduces from its seed, and ``train.precompile``
warms every bucket shape without changing a bit of it; held on the CPU.

- ``ops.ctc_cuda.LabelGather``, the CTC label gather whose backward sums
  the states of a class by a one-hot product in a fixed order (on the
  card ``torch.gather``'s backward sums them with atomics), gives
  ``torch.gather``'s gradient within 1e-6 of its scale, and the same
  bits from two calls, under a seeded cotangent (labels of width 0
  too) and under the CTC DP's own (an infeasible row and a row of no
  label in the batch). ``ctc_loss``'s gradient through it is held to
  the reference's by ``tests/test_torch_ctc.py``, unchanged.
- ``train.precompile_bucket_shapes`` (the counterpart of
  ``ctc_asr_tpu/train.py:205``) calls the step once per bucket shape, on
  a zeros copy of the state, and leaves the state, its generators and
  the loader's cursor as they were; it raises when a warm step fails; a
  tiny two-bucket ``train`` with dropout and SpecAugment gives the same
  bits with ``train.precompile`` on and off. ``train`` warms only the
  single-process step of a run with more than one bucket, as the
  reference does (``ctc_asr_tpu/train.py:371``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ctc_asr_tpu_torch import train as t_train
from ctc_asr_tpu_torch.config import (Config, DataConfig, FeatureConfig,
                                      MeshConfig, ModelConfig, TrainConfig)
from ctc_asr_tpu_torch.data import DataLoader, read_manifest
from ctc_asr_tpu_torch.data.feature_cache import build_feature_cache
from ctc_asr_tpu_torch.data.synth import generate_corpus
from ctc_asr_tpu_torch.ops import ctc_cuda
from ctc_asr_tpu_torch.parallel.mesh import ProcessMesh
from torch_threads import one_thread  # noqa: F401  (autouse)

GATHER_RTOL = 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return generate_corpus(str(d), num_utterances=12, seed=5)


def _ctc_case(seed, B, T, C, U):
    """Seeded logits and labels; when U > 1, row 0 is infeasible (a label
    sequence longer than its frames) and row 1 has no label (U = 0 in a
    padded batch)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    labels = rng.integers(0, C - 1, size=(B, U)).astype(np.int32)
    lens = rng.integers(max(1, T // 2), T + 1, B).astype(np.int32)
    llens = (rng.integers(1, U + 1, B) if U else np.zeros(B)).astype(np.int32)
    if U > 1:
        lens[0], llens[0], llens[1] = 1, U, 0
    return logits, lens, labels, llens


# "u0": labels of width 0, one (blank) state a row
GATHER_CASES = {"charset": (0, 6, 40, 29, 12), "ragged": (1, 4, 6, 8, 5),
                "u0": (2, 3, 9, 7, 0)}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_label_gather_gradient_matches_torch_gather(case):
    """The gather's forward is ``torch.gather``'s, bit for bit; its
    gradient under a seeded cotangent is ``torch.gather``'s within
    1e-6 of the gradient's scale (another order of the same f32 sums),
    and two calls give the same bits."""
    logits, _, labels, _ = _ctc_case(*GATHER_CASES[case])
    B, T, C = logits.shape
    z = ctc_cuda.extended_labels(torch.from_numpy(labels).long(), C - 1)
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, T, z.shape[1])).astype(np.float32))

    def grad(fn):
        x = torch.log_softmax(torch.from_numpy(logits), -1) \
            .requires_grad_(True)
        y = fn(x)
        (y * cot).sum().backward()
        return y.detach(), x.grad

    want_y, want_g = grad(lambda x: torch.gather(
        x, 2, z[:, None, :].expand(-1, T, -1)))
    y, g = grad(lambda x: ctc_cuda.LabelGather.apply(x, z))
    _, g2 = grad(lambda x: ctc_cuda.LabelGather.apply(x, z))
    assert torch.equal(y, want_y)
    scale = want_g.abs().max().item()
    assert (g - want_g).abs().max().item() <= GATHER_RTOL * scale
    assert torch.equal(g, g2)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("case", ["charset", "ragged"])
def test_ctc_gradient_through_label_gather_matches_torch_gather(
        case, use_kernel, monkeypatch):
    """The gradient of ``ctc_loss`` with respect to the logits, the DP's
    own cotangent flowing into the gather (K6 / K7's plain versions, or
    autograd through the plain α), with an infeasible row and a row of
    no label: through ``LabelGather`` and through ``torch.gather``
    within 1e-6 of its scale; two calls give the same bits. The
    reference's gradient is held by ``tests/test_torch_ctc.py``."""
    logits, lens, labels, llens = _ctc_case(*GATHER_CASES[case])

    def grad():
        x = torch.from_numpy(logits).requires_grad_(True)
        ctc_cuda.ctc_loss(x, torch.from_numpy(lens), torch.from_numpy(labels),
                          torch.from_numpy(llens),
                          blank_id=logits.shape[-1] - 1,
                          use_kernel=use_kernel).backward()
        return x.grad

    g, g2 = grad(), grad()
    monkeypatch.setattr(ctc_cuda.LabelGather, "apply", staticmethod(
        lambda lp, z: torch.gather(lp, 2,
                                   z[:, None, :].expand(-1, lp.shape[1], -1))))
    want = grad()
    assert torch.isfinite(g).all() and torch.equal(g, g2)
    assert (g - want).abs().max().item() <= \
        GATHER_RTOL * want.abs().max().item()


def _cfg(manifest, train_dir="", precompile=True, num_buckets=2,
         **mesh) -> Config:
    """A tiny conv + 2 x BiLSTM-16 on the bf16 kernel path (the kernels'
    plain mirrors on the CPU), dropout 0.2, SpecAugment on, two length
    buckets."""
    return Config(
        features=FeatureConfig(n_mels=40),
        model=ModelConfig(frontend="conv", conv_channels=(8, 8),
                          conv_kernels=((5, 11), (3, 5)), rnn_layers=2,
                          rnn_units=16, bidirectional=True, dropout=0.2,
                          compute_dtype="bfloat16", use_pallas_rnn=True),
        data=DataConfig(train_manifest=manifest, batch_size=2,
                        num_buckets=num_buckets, num_workers=1),
        train=TrainConfig(learning_rate=3e-3, log_every=1, sync_every=1,
                          checkpoint_every=0, train_dir=train_dir,
                          specaugment=True, precompile=precompile),
        mesh=MeshConfig(**mesh))


def _state_bits(state) -> dict:
    flat = {f"params/{k}": v.detach().clone()
            for k, v in state["params"].items()}
    for m in ("mu", "nu"):
        flat.update({f"{m}/{k}": v.clone()
                     for k, v in state["opt_state"][m].items()})
    flat.update({f"rng/{k}": g.get_state()
                 for k, g in state["generators"].items()})
    return flat, state["step"], state["opt_state"]["count"]


@pytest.mark.parametrize("source", ["wav", "feature_cache"])
def test_warm_up_steps_each_bucket_shape_once_and_touches_nothing(
        corpus, tmp_path, capsys, source):
    """One step per bucket, at that bucket's shapes (raw int16 samples,
    or the feature cache's [B, frames, dim] float16), on a zeros state;
    the real state (parameters, moments, count, step, generators) and
    the loader's cursor are unchanged after it, and the reference's line
    is printed."""
    cfg = _cfg(corpus)
    if source == "feature_cache":
        cache = build_feature_cache(read_manifest(corpus), cfg.data,
                                    cfg.features, str(tmp_path / "cache"),
                                    device="cpu")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, feature_cache=cache))
    loader = DataLoader(read_manifest(corpus), cfg.data, cfg.features)
    assert len(loader.spec.buckets) == 2
    state = t_train.init_train_state(cfg, "cpu")
    t_train.make_step_fn(cfg)(state, *_first_batch(cfg))  # moments != 0
    before, cursor = _state_bits(state), loader.state_dict()
    real, calls = t_train.make_step_fn(cfg), []

    def step(st, samples, slens, labels, llens):
        assert st is not state and not any(
            v.abs().sum() for v in st["params"].values())
        calls.append((tuple(samples.shape), samples.dtype,
                       tuple(labels.shape)))
        return real(st, samples, slens, labels, llens)

    capsys.readouterr()
    t_train.precompile_bucket_shapes(step, state, loader, cfg)
    out = capsys.readouterr().out
    assert "[train] precompiled 2 bucket shapes in " in out
    if source == "wav":
        want = [((2, b.max_samples), torch.int16, (2, b.max_label_len))
                for b in loader.spec.buckets]
    else:
        want = [((2, loader.bucket_frames(i), loader.cache.dim),
                 torch.float16, (2, b.max_label_len))
                for i, b in enumerate(loader.spec.buckets)]
    assert calls == want
    after = _state_bits(state)
    assert after[1:] == before[1:]
    assert before[0].keys() == after[0].keys()
    assert all(torch.equal(before[0][k], after[0][k]) for k in before[0])
    assert loader.state_dict() == cursor


def _first_batch(cfg):
    loader = DataLoader(read_manifest(cfg.data.train_manifest), cfg.data,
                        cfg.features)
    b = next(loader.iter_epoch(0))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (b.samples, b.sample_lengths, b.labels, b.label_lengths)]


def test_warm_up_failure_raises(corpus):
    """A warm step that fails raises out of the warm-up; nothing falls
    back to warming lazily."""
    cfg = _cfg(corpus)
    loader = DataLoader(read_manifest(corpus), cfg.data, cfg.features)

    def step(*_):
        raise RuntimeError("no plan for this shape")

    with pytest.raises(RuntimeError, match="no plan for this shape"):
        t_train.precompile_bucket_shapes(
            step, t_train.init_train_state(cfg, "cpu"), loader, cfg)


def _records(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: (r["loss"], r["lr"], r["grad_norm"], r["bucket"])
            for r in recs if "loss" in r}


def test_precompile_on_and_off_give_the_same_bits(corpus, tmp_path, capsys):
    """Eight steps of a two-bucket run with dropout and SpecAugment, with
    ``train.precompile`` on and off: the same losses, rates, norms and
    buckets at every step, and every array of the final checkpoint
    (parameters, moments, counts, generators) bit for bit."""
    runs = {}
    for on in (True, False):
        tdir = str(tmp_path / f"precompile_{on}")
        capsys.readouterr()
        t_train.train(_cfg(corpus, tdir, precompile=on), "cpu", max_steps=8)
        printed = "[train] precompiled 2 bucket shapes" in \
            capsys.readouterr().out
        assert printed == on
        with np.load(os.path.join(tdir, "ckpt", "step_00000008.npz")) as z:
            runs[on] = (_records(tdir), {k: z[k] for k in z.files})
    (rec_on, flat_on), (rec_off, flat_off) = runs[True], runs[False]
    assert sorted(rec_on) == list(range(1, 9))
    assert {b for *_, b in rec_on.values()} == {0, 1}
    assert rec_on == rec_off
    assert flat_on.keys() == flat_off.keys()
    assert any(k.startswith("torch_rng/") for k in flat_on)
    for k in flat_on:
        np.testing.assert_array_equal(flat_on[k], flat_off[k], err_msg=k)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("regime", ["one_bucket", "dp", "tp", "sp",
                                    "single"])
def test_train_warms_only_the_single_process_step(corpus, tmp_path,
                                                  monkeypatch, regime):
    """``train`` warms each bucket shape for the single-process step of a
    run with more than one bucket, and nothing with one bucket, in a
    ``torch.distributed`` group (data parallelism; a gloo group of one
    here), on a tensor-parallel mesh (the grid and the sharded step
    stood in for: the branch alone is under test) or with sequence
    parallelism (two CPU shards)."""
    calls, real = [], t_train.precompile_bucket_shapes
    monkeypatch.setattr(
        t_train, "precompile_bucket_shapes",
        lambda step_fn, state, loader, cfg: real(
            lambda st, samples, *_: calls.append(samples.shape), state,
            loader, cfg))
    tdir = str(tmp_path / "run")
    cfg = _cfg(corpus, tdir, num_buckets=1 if regime == "one_bucket" else 2,
               **({"seq_axis": 2} if regime == "sp" else {}))
    if regime == "tp":
        monkeypatch.setattr(t_train, "check_regime", lambda c: ProcessMesh(
            data=1, rank=0, model=2, shard_model=True))
        monkeypatch.setattr(t_train, "grid_groups", lambda m: None)
        monkeypatch.setattr(t_train, "sharded_keys", lambda c, m: frozenset())
        monkeypatch.setattr(t_train, "shard_state", lambda *a: None)
        monkeypatch.setattr(t_train, "make_step_fn", lambda *a: None)
    if regime == "dp":
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
            world_size=1, rank=0)
    try:
        t_train.train(cfg, "cpu", max_steps=0)
    finally:
        if regime == "dp":
            dist.destroy_process_group()
    assert len(calls) == (2 if regime == "single" else 0)
