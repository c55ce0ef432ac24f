"""The port's training slice on the CPU, held against the JAX reference:
one train step from a shared checkpoint, SpecAugment's masks, dropout,
``cli train`` end to end, checkpoints in both directions, exact resume
and the NaN trap.

The step is compared on a tiny conv + BiLSTM config with dropout 0 and
SpecAugment off (torch cannot draw JAX's random numbers), after one
step from the same npz state: the loss, the global gradient norm, the
Adam moments (every gradient leaf: mu = (1-b1) g and nu = (1-b2) g^2 of
the clipped gradient) and the updated parameters.

- f32: 2e-4 (the golden tolerance) of each leaf's scale. The port's
  CTC gradient comes from the explicit -exp(α+β-logP) of K7's plain
  version, the reference's from autodiff through its α scan; with
  logP ~ -260 the two differ at the ulp of logP, ~2e-5 relative.
- bf16: both round the same operands to bf16, but a sum-order
  difference that straddles a bf16 rounding boundary flips one ulp
  (2**-8 relative), so the moments are held to 1e-2 of each leaf's
  scale (two ulps) and the loss and norm to 1e-3. Adam's first update
  is lr * g / (|g| + eps), about lr * sign(g): where the reference's g
  is within that 1e-2 of 0 its sign, and the parameter, may differ by
  up to 2 lr; everywhere else the update agrees to eps / |g| relative,
  and the parameter is held to 2e-4 lr (measured: under 1e-8).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_asr_tpu.checkpoint import _flatten, load_checkpoint, save_checkpoint
from ctc_asr_tpu.config import (Config, DataConfig, FeatureConfig,
                                ModelConfig, TrainConfig, to_json)
from ctc_asr_tpu.data import DataLoader, read_manifest
from ctc_asr_tpu.data.synth import generate_corpus
from ctc_asr_tpu.features import _axis_masks
from ctc_asr_tpu.train import init_train_state as j_init_state
from ctc_asr_tpu.train import make_step_fn as j_make_step
from ctc_asr_tpu_torch import checkpoint as t_ckpt
from ctc_asr_tpu_torch import cli
from ctc_asr_tpu_torch import train as t_train
from ctc_asr_tpu_torch.features import axis_masks, spec_augment
from ctc_asr_tpu_torch.models.layers import dropout
from torch_threads import one_thread  # noqa: F401  (autouse)

F32_TOL = 2e-4
BF16_TOL, BF16_SCALAR_TOL = 1e-2, 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return generate_corpus(str(d), num_utterances=8, seed=5)


def _cfg(manifest, compute_dtype="float32", train_dir="", rnn_type="lstm",
         **train) -> Config:
    tcfg = dict(learning_rate=1e-3, log_every=1, sync_every=1,
                checkpoint_every=0, train_dir=train_dir)
    tcfg.update(train)
    return Config(
        features=FeatureConfig(n_mels=40),
        model=ModelConfig(frontend="conv", conv_channels=(8, 8),
                          conv_kernels=((5, 11), (3, 5)), rnn_layers=2,
                          rnn_units=16, bidirectional=True, dropout=0.0,
                          compute_dtype=compute_dtype,
                          use_pallas_rnn=False, rnn_type=rnn_type),
        data=DataConfig(train_manifest=manifest, batch_size=2,
                        num_buckets=1, num_workers=1),
        train=TrainConfig(**tcfg))


def _one_step(cfg):
    loader = DataLoader(read_manifest(cfg.data.train_manifest), cfg.data,
                        cfg.features)
    batch = next(loader.iter_epoch(0))
    arrs = (batch.samples, batch.sample_lengths, batch.labels,
            batch.label_lengths)
    jstate = j_init_state(cfg)
    flat0 = _flatten(jstate)
    jnew, jm = jax.jit(j_make_step(cfg))(jstate, *map(jnp.asarray, arrs))
    state = t_train.state_from_parts(
        cfg, *t_ckpt.state_from_flat(flat0, cfg), torch.device("cpu"))
    m = t_train.make_step_fn(cfg)(
        state, *[torch.from_numpy(np.ascontiguousarray(a)) for a in arrs])
    return flat0, _flatten(jnew), jm, t_train.state_to_flat(cfg, state), m


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_one_step_matches_reference(corpus, compute_dtype):
    _check_one_step(_cfg(corpus, compute_dtype))


@pytest.mark.parametrize("rnn_type,compute_dtype", [
    ("gru", "float32"), ("gru", "bfloat16"), ("rnn", "float32")])
def test_one_step_gru_and_vanilla_match_reference(corpus, rnn_type,
                                                  compute_dtype):
    """The same step with a conv + BiGRU and a conv + Bi-tanh-RNN model,
    at the same limits."""
    _check_one_step(_cfg(corpus, compute_dtype, rnn_type=rnn_type))


def _check_one_step(cfg):
    compute_dtype = cfg.model.compute_dtype
    flat0, want, jm, got, m = _one_step(cfg)
    f32 = compute_dtype == "float32"
    tol, stol = (F32_TOL, F32_TOL) if f32 else (BF16_TOL, BF16_SCALAR_TOL)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=stol)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=stol)
    assert m["lr"] == pytest.approx(float(jm["lr"]))
    assert set(got) - set(want) == {"torch_rng/dropout",
                                    "torch_rng/specaugment"}
    lr = cfg.train.learning_rate
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "rng":
            continue
        if k.startswith("opt_state/") and (".mu/" in k or ".nu/" in k):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=k)
        elif k.startswith("params/"):
            if f32:
                np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL
                                           * np.abs(w).max(), err_msg=k)
            else:
                g_ref = np.abs(want["opt_state/1/0/.mu/" + k[7:]])
                near0 = g_ref <= tol * g_ref.max()
                np.testing.assert_allclose(g[~near0], w[~near0], rtol=0,
                                           atol=F32_TOL * lr, err_msg=k)
                np.testing.assert_allclose(g[near0], w[near0], rtol=0,
                                           atol=2 * lr, err_msg=k)
            assert not np.array_equal(g, flat0[k]), k       # it moved
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)   # counts, step


def _reference_kernel_path(monkeypatch):
    """Make the reference's encoder take its Pallas train path on the
    CPU, as its own tests do (``tests/test_models.py``): the dispatch
    says yes to every flag that is not False, and the fused BiLSTM
    layer runs ``lstm_seq_pallas`` in interpret mode. ``_pick_tt`` is
    held at one step a block: the block depth only sets how many steps
    one grid iteration unrolls (the carried h and c stay f32 in scratch
    between blocks), and interpret mode compiles the unrolled body, so
    one step a block cuts the compile from ~50 to ~15 s at ds3 width.
    The config must turn the STFT and CTC kernels off itself."""
    import functools
    from ctc_asr_tpu.models import rnn as rnn_mod
    from ctc_asr_tpu.ops import dispatch
    from ctc_asr_tpu.ops import lstm_pallas
    monkeypatch.setattr(dispatch, "resolve_use_pallas",
                        lambda f: f is not False)
    monkeypatch.setattr(rnn_mod, "birnn_pair_apply", functools.partial(
        rnn_mod.birnn_pair_apply, interpret=True))
    monkeypatch.setattr(lstm_pallas, "_pick_tt", lambda *a: 1)


def _seq_cfg(corpus, case) -> Config:
    """The config of a ``test_loss_sequence_matches_reference`` case:
    twelve steps, warm-up of four."""
    schedule = "constant" if case == "constant" else "warmup_cosine"
    cfg = _cfg(corpus, lr_schedule=schedule, warmup_steps=4,
               total_steps=12, learning_rate=3e-3)
    if case == "bf16_kernel_5x_bilstm":
        # the ladder's ds3 arm cut to width 16: five BiLSTM layers, bf16,
        # the kernel path (the reference's Pallas kernels in interpret
        # mode, the port's K2 / K3 plain mirrors); the STFT and CTC
        # kernels off on both sides (their CPU paths are the plain ones)
        cfg = dataclasses.replace(
            cfg, features=dataclasses.replace(cfg.features,
                                              use_pallas=False),
            model=dataclasses.replace(cfg.model, rnn_layers=5,
                                      compute_dtype="bfloat16",
                                      use_pallas_rnn=True),
            train=dataclasses.replace(cfg.train, use_pallas_ctc=False))
    elif case == "pr1_dense_uni":
        # pr1's geometry (``pr1_mfcc_uni``): MFCC 26, a dense frontend of
        # two layers, two unidirectional LSTM layers; width 16, f32
        cfg = dataclasses.replace(
            cfg, features=FeatureConfig(feature_type="mfcc", n_mfcc=26),
            model=dataclasses.replace(cfg.model, frontend="dense",
                                      dense_layers=2, dense_units=16,
                                      bidirectional=False))
    return cfg


@pytest.mark.parametrize("case", ["constant", "warmup_cosine",
                                  "bf16_kernel_5x_bilstm", "pr1_dense_uni"])
def test_loss_sequence_matches_reference(corpus, case, monkeypatch):
    """Twelve steps from one state on the same batches (dropout 0, no
    SpecAugment, as the synth runners train): the port's loss, gradient
    norm and learning rate follow the reference's at every step, and
    the parameters after the last step agree leaf by leaf. One step
    does not reach Adam's moments after their first update, its bias
    correction past step 1, the schedule past step 0 or gradients of a
    state that has moved.

    Cases: conv + 2 x BiLSTM in f32 on the plain path, with either
    schedule; ``bf16_kernel_5x_bilstm``, the ladder's ds3 arm (bf16, the
    kernel path, five BiLSTM layers) at width 16; ``pr1_dense_uni``,
    pr1's geometry (MFCC, dense frontend, unidirectional LSTM) in f32.

    Tolerances. f32: loss and norm at the golden 2e-4 at every step.
    bf16: loss and norm at the one-step limit, 1e-3 and 1e-2, at EVERY
    step: one ulp of bf16 that a sum-order difference flips stays at
    that size, while a drift that grows step by step would cross it
    (measured: loss within 9.1e-5 and norm within 4.4e-4 over the
    twelve steps). The parameters: each leaf's displacement from the
    start, ``p_k - p_0``, against the reference's, by cosine and by the
    norm of the difference relative to the reference's displacement.
    Adam moves a parameter whose gradient is near 0 by about lr
    sign(g), so a gradient within an ulp of 0 can move it 2 lr the
    other way (``_check_one_step``): the relative error is held to 1e-3
    in f32 (measured ≤ 3.8e-5) and 3e-2 in bf16 (measured ≤ 9.8e-3,
    the first conv), the cosine to 0.9999 and 0.999 (bf16 measured
    ≥ 0.99995)."""
    if case == "bf16_kernel_5x_bilstm":
        _reference_kernel_path(monkeypatch)
    cfg = _seq_cfg(corpus, case)
    loader = DataLoader(read_manifest(cfg.data.train_manifest), cfg.data,
                        cfg.features)
    batches = [b for epoch in range(3) for b in loader.iter_epoch(epoch)]
    assert len(batches) == 12
    jstate = j_init_state(cfg)
    flat0 = _flatten(jstate)
    state = t_train.state_from_parts(
        cfg, *t_ckpt.state_from_flat(flat0, cfg), torch.device("cpu"))
    jstep, step = jax.jit(j_make_step(cfg)), t_train.make_step_fn(cfg)
    got, want = [], []
    for b in batches:
        arrs = (b.samples, b.sample_lengths, b.labels, b.label_lengths)
        jstate, jm = jstep(jstate, *map(jnp.asarray, arrs))
        m = step(state, *[torch.from_numpy(np.ascontiguousarray(a))
                          for a in arrs])
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    got, want = np.array(got), np.array(want)
    assert (want[1:, 2] > 0).all()
    # the reference evaluates its schedule in f32: a few ulps (measured
    # 1.2e-6 relative at a cosine step)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5)
    f32 = cfg.model.compute_dtype == "float32"
    ltol, ntol = (F32_TOL, F32_TOL) if f32 else (BF16_SCALAR_TOL, BF16_TOL)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=ltol)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=ntol)
    rtol, min_cos = (1e-3, 0.9999) if f32 else (3e-2, 0.999)
    jflat, tflat = _flatten(jstate), t_train.state_to_flat(cfg, state)
    leaves = [k for k in jflat if k.startswith("params/")]
    assert len(leaves) == len(t_train.init_train_state(cfg)["params"])
    for k in leaves:
        dw = jflat[k].astype(np.float64) - flat0[k]
        dg = tflat[k].astype(np.float64) - flat0[k]
        cos = (dw * dg).sum() / (np.linalg.norm(dw) * np.linalg.norm(dg))
        rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert cos >= min_cos and rel <= rtol, (k, cos, rel)


def test_one_step_at_ds3_width_matches_reference(monkeypatch):
    """One train step of the ladder's ds3 model at its full width
    (``deepspeech_beam``: the preset's two convs, 5 x BiLSTM-800), bf16,
    the kernel path: the reference's Pallas kernels in interpret mode,
    the port's K2 / K3 plain mirrors. H=800 is not a multiple of 64, so
    this is where width-dependent code in the mirrors, the encoder's
    layouts or ``params_from_jax`` would show. B=2, 1.0 and 0.7 s of
    seeded noise, labels of 12 and 7 characters, dropout 0, no
    SpecAugment.

    Every gradient leaf (Adam's first moment, (1 - b1) g of the clipped
    gradient) is held by its cosine to the reference's, >= 0.999, and
    by the norm of the difference over the reference's norm, <= 2e-2.
    Both sides round wh's, wx's and the convs' gradients to bf16, so a
    sum-order difference shows as a one-ulp flip (2**-8) in a share of
    the elements: measured 1.8-2.2e-3 for every wh and wx, 9.7e-3 for
    the first conv (its bf16 transpose sums T x F products an element),
    where the reference's own Pallas and scan paths differ by 2.8-8.5e-3
    and 7.9e-3 on the same step. The loss and the norm at the one-step
    bf16 limit, 1e-3."""
    from ctc_asr_tpu.config import preset as j_preset
    _reference_kernel_path(monkeypatch)
    base = j_preset("deepspeech_beam")
    cfg = dataclasses.replace(
        base, features=dataclasses.replace(base.features, use_pallas=False),
        model=dataclasses.replace(base.model, dropout=0.0,
                                  use_pallas_rnn=True),
        train=dataclasses.replace(base.train, use_pallas_ctc=False,
                                  learning_rate=3e-4))
    assert (cfg.model.rnn_layers, cfg.model.rnn_units,
            cfg.model.compute_dtype) == (5, 800, "bfloat16")
    rng = np.random.default_rng(0)
    S = 16000
    samples = (rng.standard_normal((2, S)) * 0.1).astype(np.float32)
    slens = np.array([S, 11200], np.int32)
    samples[1, 11200:] = 0
    labels = np.zeros((2, 12), np.int32)
    labels[0] = rng.integers(1, 29, 12)
    labels[1, :7] = rng.integers(1, 29, 7)
    arrs = (samples, slens, labels, np.array([12, 7], np.int32))
    jstate = j_init_state(cfg)
    flat0 = _flatten(jstate)
    jnew, jm = jax.jit(j_make_step(cfg))(jstate, *map(jnp.asarray, arrs))
    state = t_train.state_from_parts(
        cfg, *t_ckpt.state_from_flat(flat0, cfg), torch.device("cpu"))
    m = t_train.make_step_fn(cfg)(state, *map(torch.from_numpy, arrs))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=BF16_SCALAR_TOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=BF16_SCALAR_TOL)
    want, got = _flatten(jnew), t_train.state_to_flat(cfg, state)
    mus = [k for k in want if ".mu/" in k]
    assert len(mus) == 2 + 2 + 5 * 2 * 3 + 2
    for k in mus:
        w, g = want[k].astype(np.float64), got[k].astype(np.float64)
        cos = (w * g).sum() / (np.linalg.norm(w) * np.linalg.norm(g))
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert cos >= 0.999 and rel <= 2e-2, (k, cos, rel)


def test_axis_masks_match_reference_draws():
    """The reference's own uniforms, fed to the port's mask builder."""
    B, T, F, n = 5, 50, 40, 2
    rng = jax.random.PRNGKey(3)
    lens = jnp.asarray([50, 31, 7, 1, 0], jnp.float32)
    for length, maxw, limit in ((T, jnp.floor(0.2 * lens), lens),
                                (F, jnp.full((B,), 15.0), jnp.full((B,), F))):
        want = np.asarray(_axis_masks(rng, n, length, maxw, limit))
        k1, k2 = jax.random.split(rng)
        u_w, u_s, maxw_t, limit_t = (
            torch.from_numpy(np.array(a)) for a in (
                jax.random.uniform(k1, (B, n)),
                jax.random.uniform(k2, (B, n)), maxw, limit))
        got = axis_masks(u_w, u_s, length, maxw_t, limit_t)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any()


def test_spec_augment_masks_spans_within_bounds():
    B, T, F = 64, 80, 40
    feats = torch.ones(B, T, F)
    lens = torch.randint(1, T + 1, (B,), generator=torch.Generator()
                         .manual_seed(0))
    out = spec_augment(feats, lens, 2, 0.1, 2, 7,
                       torch.Generator().manual_seed(1))
    t_masked = (out == 0).all(dim=2)                  # [B, T]
    f_masked = (out == 0).all(dim=1)                  # [B, F]
    assert t_masked.any() and f_masked.any()
    for b in range(B):
        tm = t_masked[b].numpy()
        if f_masked[b].all():
            continue
        assert not tm[int(lens[b]):].any()            # inside [0, len)
        assert tm.sum() <= 2 * int(0.1 * int(lens[b]))
        assert f_masked[b].sum() <= 2 * 7
    again = spec_augment(feats, lens, 2, 0.1, 2, 7,
                         torch.Generator().manual_seed(1))
    assert torch.equal(out, again)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert dropout(x, 0.0, None) is x


def test_remat_gives_the_same_gradients():
    """cfg.remat recomputes each RNN layer in the backward pass with the
    dropout masks drawn once outside it: gradients are unchanged."""
    from ctc_asr_tpu_torch.models import apply_encoder, init_params
    cfg = dataclasses.replace(_cfg("").model, dropout=0.3,
                              use_pallas_rnn=True)
    params = {k: v.requires_grad_(True) for k, v in init_params(
        cfg, 40, torch.Generator().manual_seed(0)).items()}
    feats = torch.randn(3, 30, 40, generator=torch.Generator().manual_seed(1))
    flens = torch.tensor([30, 17, 5], dtype=torch.int32)
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        logits, _ = apply_encoder(params, feats, flens, c, train=True,
                                  generator=torch.Generator().manual_seed(2))
        grads.append(torch.autograd.grad(logits.square().sum(),
                                         list(params.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _cli_train(cfg, tmp_path, *extra):
    path = tmp_path / f"cfg_{len(os.listdir(tmp_path))}.json"
    path.write_text(to_json(cfg))
    assert cli.main(["train", "--config", str(path), "--device=cpu",
                     *extra]) == 0


def _losses(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["loss"] for r in recs if "loss" in r}


def test_cli_train_learns_and_writes_reference_checkpoints(corpus, tmp_path):
    tdir = str(tmp_path / "run")
    cfg = dataclasses.replace(
        _cfg(corpus, train_dir=tdir, learning_rate=1e-2, checkpoint_every=4,
             eval_every=8, keep_checkpoints=2),
        data=dataclasses.replace(_cfg(corpus).data, eval_manifest=corpus))
    _cli_train(cfg, tmp_path, "--max-steps=12",
               "--model.use_pallas_rnn=true")
    losses = _losses(tdir)
    assert sorted(losses) == list(range(1, 13))
    assert all(np.isfinite(v) for v in losses.values())
    first = np.mean([losses[k] for k in (1, 2, 3)])
    last = np.mean([losses[k] for k in (10, 11, 12)])
    assert last < first
    ckpts = sorted(os.listdir(os.path.join(tdir, "ckpt")))
    assert ckpts == ["best.json", "best.npz", "step_00000008.json",
                     "step_00000008.npz", "step_00000012.json",
                     "step_00000012.npz"]
    want = _flatten(j_init_state(cfg))
    with np.load(os.path.join(tdir, "ckpt", "step_00000012.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert set(want) <= set(got)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert int(got["step"]) == 12
    # the reference's loader reads it into its own train state
    state, meta = load_checkpoint(
        os.path.join(tdir, "ckpt", "step_00000012.npz"), j_init_state(cfg))
    assert int(state["step"]) == 12 and meta["loader"]["position"] >= 1
    np.testing.assert_array_equal(np.asarray(state["params"]["head"]["w"]),
                                  got["params/head/w"])


def test_resume_from_reference_checkpoint(corpus, tmp_path):
    """A JAX-written train state (moments, counts, step and the loader
    cursor) is restored exactly; the port then trains on from it."""
    tdir = str(tmp_path / "run")
    cfg = _cfg(corpus, train_dir=tdir)
    jstate = j_init_state(cfg)
    rng = np.random.default_rng(0)
    jstate["opt_state"] = jax.tree.map(
        lambda a: (jnp.full_like(a, 3) if a.dtype == jnp.int32 else
                   jnp.asarray(rng.uniform(0, 1e-3, a.shape), a.dtype)),
        jstate["opt_state"])
    jstate["step"] = jnp.asarray(3, jnp.int32)
    save_checkpoint(tdir + "/ckpt", 3, jstate,
                    metadata={"loader": {"epoch": 0, "position": 1,
                                         "seed": 0}},
                    process_index=0)
    flat = _flatten(jstate)
    params, opt_state, step, rngs = t_ckpt.state_from_flat(flat, cfg)
    assert step == 3 and opt_state["count"] == 3 and rngs == {}
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), flat[f"params/{k}"])
        np.testing.assert_array_equal(opt_state["nu"][k].numpy(),
                                      flat[f"opt_state/1/0/.nu/{k}"])
    state = t_train.train(cfg, "cpu", max_steps=5)
    assert state["step"] == 5 and state["opt_state"]["count"] == 5
    with open(os.path.join(tdir, "ckpt", "step_00000005.json")) as f:
        cursor = json.load(f)["loader"]
    # batches 1 and 2 of epoch 0 were trained after the restored cursor
    assert (cursor["epoch"], cursor["position"]) == (0, 3)


def test_resume_gives_the_uninterrupted_loss_sequence(corpus, tmp_path):
    """With dropout and SpecAugment on, the restored generators and
    loader cursor give the same losses as one run straight through."""
    model = dataclasses.replace(_cfg(corpus).model, dropout=0.2)
    full = dataclasses.replace(
        _cfg(corpus, train_dir=str(tmp_path / "full"), specaugment=True),
        model=model)
    part = dataclasses.replace(
        _cfg(corpus, train_dir=str(tmp_path / "part"), specaugment=True),
        model=model)
    t_train.train(full, "cpu", max_steps=6)
    t_train.train(part, "cpu", max_steps=3)
    t_train.train(part, "cpu", max_steps=6)
    want, got = _losses(full.train.train_dir), _losses(part.train.train_dir)
    assert sorted(got) == list(range(1, 7))
    for k in range(1, 7):
        assert got[k] == want[k], (k, got[k], want[k])


def test_generator_state_from_another_device_raises(corpus, tmp_path):
    """A checkpoint whose generator state does not fit this device's
    generator (16 bytes is a CUDA Philox state; a CPU one is 5056) is
    refused, not reseeded: the resumed draws would differ."""
    tdir = str(tmp_path / "run")
    cfg = _cfg(corpus, train_dir=tdir)
    flat = t_train.state_to_flat(cfg, t_train.init_train_state(cfg))
    flat["torch_rng/dropout"] = np.zeros(16, np.uint8)
    t_ckpt.save_checkpoint(tdir + "/ckpt", 0, flat)
    with pytest.raises(ValueError, match="another kind of device"):
        t_train.train(cfg, "cpu", max_steps=1)


def test_nan_trap_raises(corpus, tmp_path):
    tdir = str(tmp_path / "run")
    cfg = _cfg(corpus, train_dir=tdir)
    jstate = j_init_state(cfg)
    jstate["params"]["rnn"][0]["fwd"]["wh"] = \
        jstate["params"]["rnn"][0]["fwd"]["wh"].at[0, 0].set(jnp.nan)
    save_checkpoint(tdir + "/ckpt", 0, jstate, process_index=0)
    with pytest.raises(FloatingPointError, match="grad_norm is NaN"):
        t_train.train(cfg, "cpu", max_steps=2)


def test_unported_regimes_raise(corpus, tmp_path):
    """What the reference refuses raises before any work: sequence
    parallelism with more than one process, a model axis that does not
    divide the processes (one here), ``num_processes=2`` with no process
    group formed. The regimes themselves run: ``shard_model`` on a model
    axis of one process, ``seq_axis=2`` in one process over two CPU
    shards, and a coordinator alone is one process, as in the reference
    (its ``initialize_distributed`` is a no-op without ``num_processes >
    1``)."""
    cfg = _cfg(corpus, train_dir=str(tmp_path / "run"))
    for mesh, err, match in (
            (dict(seq_axis=2, num_processes=2), ValueError,
             "seq_axis=2 is not supported with multi-process"),
            (dict(model_axis=2), ValueError,
             "1 devices not divisible by model axis 2"),
            (dict(model_axis=2, shard_model=True), ValueError,
             "not divisible by model axis 2"),
            (dict(num_processes=2), RuntimeError, "no.*is formed")):
        bad = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, **mesh))
        with pytest.raises(err, match=match):
            t_train.train(bad, "cpu", max_steps=1)
    assert not os.path.exists(tmp_path / "run")
    for i, mesh in enumerate((dict(coordinator_address="localhost:1234"),
                              dict(shard_model=True), dict(seq_axis=2))):
        ok = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, **mesh), train=dataclasses.replace(
                cfg.train, train_dir=str(tmp_path / f"ok{i}")))
        assert t_train.train(ok, "cpu", max_steps=1)["step"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_train.train(cfg, "cuda", max_steps=1)
        seq = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, seq_axis=2))
        with pytest.raises(RuntimeError, match="CUDA"):
            t_train.train(seq, "cuda", max_steps=1)


def test_unported_regimes_raise_in_evaluate_and_transcribe(corpus, tmp_path):
    """``evaluate`` (and with it the train-time ``eval_fn`` of ``cli
    train``) and ``cli evaluate`` refuse what the reference refuses
    (sequence parallelism with more than one process, a model axis that
    does not divide the processes) and ``num_processes=2`` with no group
    formed before they load or decode anything; a coordinator alone is
    one process and ``seq_axis=2`` runs in one process, so ``cli
    evaluate`` goes on to the (missing) checkpoint. ``cli transcribe``
    runs in one process and refuses every mesh setting; the
    single-process config evaluates."""
    from ctc_asr_tpu_torch.evaluate import evaluate
    cfg = _cfg(corpus)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, eval_manifest=corpus))
    wav = read_manifest(corpus)[0].path
    missing = str(tmp_path / "no_such_checkpoint.npz")
    for mesh, err, match in (
            (dict(seq_axis=2, num_processes=2), ValueError,
             "not supported with multi-process"),
            (dict(model_axis=2), ValueError, "not divisible by model axis"),
            (dict(num_processes=2), RuntimeError, "no.*is formed"),
            (dict(coordinator_address="localhost:1234"), FileNotFoundError,
             "no_such_checkpoint"),
            (dict(seq_axis=2), FileNotFoundError, "no_such_checkpoint")):
        bad = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, **mesh))
        if err is not FileNotFoundError:
            with pytest.raises(err, match=match):
                evaluate(bad, None, "cpu")
        flags = [f"--mesh.{k}={v}" for k, v in mesh.items()]
        with pytest.raises(err, match=match):
            cli.main(["evaluate", "--ckpt", missing, "--device=cpu"] + flags)
        with pytest.raises(NotImplementedError, match="one process"):
            cli.main(["transcribe", "--ckpt", missing, wav, "--device=cpu"]
                     + flags)
    params = t_train.init_train_state(cfg, "cpu")["params"]
    with torch.no_grad():
        res = evaluate(cfg, params, "cpu", max_batches=1, log_samples=0)
    assert np.isfinite(res["wer"])


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_profile_dir_writes_a_trace_and_keeps_the_loss(corpus, tmp_path,
                                                       rnn_type):
    """``train.profile_dir`` wraps the loop in a torch.profiler trace: a
    Chrome trace file appears there, it names the step's operators, and
    the losses are those of the untraced run."""
    plain = _cfg(corpus, train_dir=str(tmp_path / "plain"),
                 rnn_type=rnn_type)
    prof_dir = tmp_path / "prof"
    traced = _cfg(corpus, train_dir=str(tmp_path / "traced"),
                  rnn_type=rnn_type, profile_dir=str(prof_dir))
    t_train.train(plain, "cpu", max_steps=2)
    t_train.train(traced, "cpu", max_steps=2)
    assert _losses(traced.train.train_dir) == _losses(plain.train.train_dir)
    files = os.listdir(prof_dir)
    assert len(files) == 1 and files[0].startswith("trace_") \
        and files[0].endswith(".json")
    with open(prof_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("bmm" in e.get("name", "") for e in events)


def test_time_fn_and_maybe_trace(tmp_path):
    """``maybe_trace("")`` traces nothing; given a directory it writes one
    Chrome trace that holds the spans opened inside it."""
    from ctc_asr_tpu_torch.utils import profiling
    with profiling.maybe_trace("") as t:
        assert t is None
        with profiling.span("test.untraced"):
            pass
    with profiling.maybe_trace(str(tmp_path)) as t:
        assert t is not None
        with profiling.span("test.traced"):
            torch.ones(2).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "test.traced" in names and "test.untraced" not in names
