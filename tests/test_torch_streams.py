"""The port's random streams and resume across steps, held on the CPU.

The ladder's 8000-step arms are continuations (``scripts/continue_rung``
resumes a 4000-step ``train_<rung>`` directory), and every arm trains
with dropout and SpecAugment. The mask math is held elsewhere given the
reference's uniforms (``test_torch_train.py``); here the streams that
feed it:

- a run saved at step k and resumed to 2k equals one run straight to
  2k bit for bit (per-step losses, learning rates and norms, and every
  array of the checkpoints at k and 2k, the generators', the moments'
  and the counts' included), whether the resume raises the step budget
  as ``continue_rung`` does or ``--max-steps`` cuts the run;
- over many steps, the share of frames and of mel bins that
  SpecAugment masks in ``train._train_features`` matches the reference's
  ``spec_augment`` under ``fold_in(dropout_rng, 7)`` of its own step
  keys (``ctc_asr_tpu/train.py:115-124``), and dropout's kept share in
  ``apply_encoder`` matches ``layers.dropout`` under the reference's
  per-layer keys, each within four standard errors; no step repeats
  the previous one's masks.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_asr_tpu import features as j_feat
from ctc_asr_tpu.models import layers as j_layers
from ctc_asr_tpu.train import init_train_state as j_init_state
from ctc_asr_tpu_torch import train as t_train
from ctc_asr_tpu_torch.config import (Config, DataConfig, FeatureConfig,
                                      ModelConfig, TrainConfig)
from ctc_asr_tpu_torch.data import DataLoader, read_manifest
from ctc_asr_tpu_torch.data.synth import generate_corpus
from ctc_asr_tpu_torch.models import encoder as t_enc
from ctc_asr_tpu_torch.models import layers as t_layers
from torch_threads import one_thread  # noqa: F401  (autouse)

# the statistical tests' bound, in standard errors of the difference
N_SE = 4.0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return generate_corpus(str(d), num_utterances=8, seed=5)


def _cfg(manifest, train_dir="", batch_size=2, **train) -> Config:
    """A tiny conv + 2 x BiLSTM-16 on the bf16 kernel path (the kernels'
    plain mirrors on the CPU), dropout 0.2, SpecAugment on: the ds3+SA
    arm's settings at a toy width."""
    tcfg = dict(learning_rate=3e-3, log_every=1, sync_every=1,
                checkpoint_every=0, train_dir=train_dir, specaugment=True)
    tcfg.update(train)
    return Config(
        features=FeatureConfig(n_mels=40),
        model=ModelConfig(frontend="conv", conv_channels=(8, 8),
                          conv_kernels=((5, 11), (3, 5)), rnn_layers=2,
                          rnn_units=16, bidirectional=True, dropout=0.2,
                          compute_dtype="bfloat16", use_pallas_rnn=True),
        data=DataConfig(train_manifest=manifest, batch_size=batch_size,
                        num_buckets=1, num_workers=1),
        train=TrainConfig(**tcfg))


def _records(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: (r["loss"], r["lr"], r["grad_norm"])
            for r in recs if "loss" in r}


def _checkpoint(train_dir, step):
    path = os.path.join(train_dir, "ckpt", f"step_{step:08d}")
    with np.load(path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    with open(path + ".json") as f:
        return flat, json.load(f)["loader"]


@pytest.mark.parametrize("resume", ["continue_rung", "max_steps"])
def test_resume_at_k_equals_the_unbroken_run(corpus, tmp_path, resume):
    """Five steps, saved, resumed to ten, against ten straight through
    (a checkpoint at five): the resume crosses an epoch boundary (four
    batches an epoch) into a shuffled epoch. ``continue_rung``: the
    first leg's step budget is k and the resume raises it to 2k, as
    ``continue_rung`` does to a ladder arm (a constant rate, as the
    ladder trains). ``max_steps``: one budget of 2k under a warm-up +
    cosine schedule, the first leg cut at k, so that the learning rate
    of every resumed step hangs on the restored count. Everything is
    bit-equal on the CPU."""
    k = 5
    sched = dict(lr_schedule="constant") if resume == "continue_rung" \
        else dict(lr_schedule="warmup_cosine", warmup_steps=3)
    full = _cfg(corpus, str(tmp_path / "full"), total_steps=2 * k,
                checkpoint_every=k, **sched)
    part_dir = str(tmp_path / "part")
    t_train.train(full, "cpu")
    if resume == "continue_rung":
        t_train.train(_cfg(corpus, part_dir, total_steps=k,
                           checkpoint_every=k, **sched), "cpu")
        t_train.train(_cfg(corpus, part_dir, total_steps=2 * k,
                           checkpoint_every=2 * k, **sched), "cpu")
    else:
        part = dataclasses.replace(full, train=dataclasses.replace(
            full.train, train_dir=part_dir))
        t_train.train(part, "cpu", max_steps=k)
        t_train.train(part, "cpu")
    want, got = _records(full.train.train_dir), _records(part_dir)
    assert sorted(got) == sorted(want) == list(range(1, 2 * k + 1))
    for s in want:
        assert got[s] == want[s], (s, got[s], want[s])
    if resume == "max_steps":
        lrs = [want[s][1] for s in sorted(want)]
        assert len(set(lrs)) == len(lrs)        # the rate moves every step
    for s in (k, 2 * k):
        (wflat, wcur), (gflat, gcur) = (_checkpoint(full.train.train_dir, s),
                                        _checkpoint(part_dir, s))
        assert gcur == wcur, (s, gcur, wcur)
        assert set(gflat) == set(wflat)
        assert {"torch_rng/dropout", "torch_rng/specaugment"} <= set(wflat)
        for key, w in wflat.items():
            np.testing.assert_array_equal(gflat[key], w, err_msg=f"{s} {key}")
    # the restored generators moved on: step 2k's are not step k's
    kflat, _ = _checkpoint(part_dir, k)
    assert not np.array_equal(kflat["torch_rng/dropout"],
                              gflat["torch_rng/dropout"])


def _within(a, b, what):
    """Per-step samples a, b: their means agree within N_SE standard
    errors of the difference."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    assert abs(a.mean() - b.mean()) <= N_SE * se, (
        what, a.mean(), b.mean(), se)


def _reference_step_keys(cfg, n):
    """The reference step's ``dropout_rng`` for steps 0..n-1: each step
    splits the state's rng into (next rng, dropout_rng)."""
    rng = j_init_state(cfg)["rng"]
    keys = []
    for _ in range(n):
        rng, dropout_rng = jax.random.split(rng)
        keys.append(dropout_rng)
    return keys


def test_specaugment_draws_match_reference_statistics(corpus):
    """300 steps of ``_train_features`` on one batch of eight utterances
    (170-350 frames, 40 mel bins, the ladder's two time masks of at most
    5% of a row's frames and two frequency masks of at most 15 bins)
    against the reference's ``spec_augment`` under the keys its step
    derives, on the same frame counts. Measured per step: the share of
    the valid frames masked and the share of the bins masked."""
    n = 300
    cfg = _cfg(corpus, batch_size=8)
    batch = next(DataLoader(read_manifest(corpus), cfg.data,
                            cfg.features).iter_epoch(0))
    samples = torch.from_numpy(np.ascontiguousarray(batch.samples))
    slens = torch.from_numpy(batch.sample_lengths)
    gens = t_train.init_train_state(cfg)["generators"]
    t_share, f_share, masks = [], [], set()
    for _ in range(n):
        feats, flens = t_train._train_features(cfg, gens, samples, slens)
        B, T, F = feats.shape
        valid = torch.arange(T)[None, :] < flens[:, None]           # [B, T]
        zero = feats == 0
        tm = zero.all(dim=2) & valid
        fm = (zero | ~valid[..., None]).all(dim=1)                  # [B, F]
        t_share.append(tm.sum().item() / valid.sum().item())
        f_share.append(fm.float().mean().item())
        masks.add(tm.numpy().tobytes() + fm.numpy().tobytes())
    assert len(masks) == n                      # no step repeats another's

    tc = cfg.train
    jflens = jnp.asarray(flens.numpy())

    @jax.jit
    def reference_masks(dropout_rng):
        out = j_feat.spec_augment(
            jax.random.fold_in(dropout_rng, 7), jnp.ones((B, T, F)), jflens,
            tc.sa_time_masks, tc.sa_time_ratio, tc.sa_freq_masks,
            tc.sa_freq_width)
        jvalid = jnp.arange(T)[None, :] < jflens[:, None]
        jzero = out == 0
        jtm = jzero.all(axis=2) & jvalid
        jfm = (jzero | ~jvalid[..., None]).all(axis=1)
        return jtm.sum() / jvalid.sum(), jfm.mean()

    ref = np.array([reference_masks(key)
                    for key in _reference_step_keys(cfg, n)])
    assert 0.01 < np.mean(t_share) < 0.1 and 0.05 < np.mean(f_share) < 0.5
    _within(t_share, ref[:, 0], "masked share of frames")
    _within(f_share, ref[:, 1], "masked share of mel bins")


def test_dropout_draws_match_reference_statistics(corpus, monkeypatch):
    """100 training-mode forwards of ``apply_encoder`` (the draws a train
    step makes from its dropout generator: one mask after each conv and
    each BiLSTM layer) at the ladder's rate 0.1, each mask recorded,
    against ``layers.dropout`` under the reference's per-layer keys
    (``jax.random.split(dropout_rng, 32)``) on masks of the same sizes.
    Measured per step: the kept share over all four masks, and the
    share of elements that a layer's mask shares with the previous
    step's (independent draws agree at keep**2 + rate**2 = 0.82; a
    stream that repeated would give 1)."""
    n, rate = 100, 0.1
    cfg = _cfg(corpus)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout=rate))
    recorded = []
    real_mask = t_layers.dropout_mask

    def recording_mask(*args, **kwargs):
        m = real_mask(*args, **kwargs)
        recorded.append(m)
        return m

    monkeypatch.setattr(t_layers, "dropout_mask", recording_mask)
    monkeypatch.setattr(t_enc, "dropout_mask", recording_mask)
    state = t_train.init_train_state(cfg)
    gen = state["generators"]["dropout"]
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 60, 40)).astype(np.float32))
    flens = torch.tensor([60, 41], dtype=torch.int32)
    steps = []
    with torch.no_grad():
        for _ in range(n):
            recorded.clear()
            t_enc.apply_encoder(state["params"], feats, flens, cfg.model,
                                train=True, generator=gen)
            steps.append([m.clone() for m in recorded])
    assert all(len(s) == 4 for s in steps)      # 2 convs + 2 BiLSTM layers
    shapes = [tuple(m.shape) for m in steps[0]]

    def kept(masks):
        return sum(m.sum() for m in masks) / sum(m.size for m in masks)

    def agree(prev, cur):
        return sum((p == c).sum() for p, c in zip(prev, cur)) / sum(
            c.size for c in cur)

    port = [[m.numpy() for m in s] for s in steps]

    @jax.jit
    def reference_masks(dropout_rng):
        keys = jax.random.split(dropout_rng, 32)
        return [j_layers.dropout(keys[i], jnp.ones(shape), rate, True) != 0
                for i, shape in enumerate(shapes)]

    ref = [[np.asarray(m) for m in reference_masks(key)]
           for key in _reference_step_keys(cfg, n)]
    t_kept, j_kept = [kept(s) for s in port], [kept(s) for s in ref]
    assert abs(np.mean(t_kept) - (1 - rate)) < 0.01
    _within(t_kept, j_kept, "dropout's kept share")
    t_agree = [agree(a, b) for a, b in zip(port, port[1:])]
    j_agree = [agree(a, b) for a, b in zip(ref, ref[1:])]
    assert max(t_agree) < 0.9
    _within(t_agree, j_agree, "agreement with the previous step's masks")
