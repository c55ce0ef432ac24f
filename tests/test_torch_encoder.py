"""The port's encoder (ctc_asr_tpu_torch.models) held against the JAX
reference on the CPU: SAME conv, NHWC flatten, parameter tree, whole
encoders, and the committed golden tiny-model outputs.

Parameters come from the reference's ``init_params`` (flattened as its
checkpoints are) and cross through ``params_from_jax``; inputs come
from numpy seeds. Tolerance 2e-4 in f32; lengths and ids exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctc_asr_tpu.checkpoint import _flatten
from ctc_asr_tpu.config import Config, FeatureConfig, ModelConfig
from ctc_asr_tpu.models import apply_encoder as j_apply
from ctc_asr_tpu.models import init_params
from ctc_asr_tpu.models import layers as jl
from ctc_asr_tpu.ops.greedy import greedy_decode as j_greedy
from ctc_asr_tpu_torch import features as tf
from ctc_asr_tpu_torch.checkpoint import params_from_jax
from ctc_asr_tpu_torch.models import apply_encoder, init_shapes, layers
from ctc_asr_tpu_torch.models import output_lengths
from ctc_asr_tpu_torch.ops.greedy import greedy_decode
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 2e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_model.npz")


def _conv_params(rng, kt, kf, cin, cout):
    return {"w": rng.standard_normal((kt, kf, cin, cout)).astype(np.float32)
            * 0.1, "b": rng.standard_normal(cout).astype(np.float32) * 0.1}


@pytest.mark.parametrize("T,F,cin,kt,kf,strides", [
    (21, 16, 1, 11, 9, (2, 2)),     # odd T, stride 2: pad 5/5 in time
    (20, 17, 3, 11, 5, (2, 2)),     # even T: asymmetric 4/5
    (13, 20, 4, 3, 21, (1, 2)),
])
def test_same_conv_matches_reference(T, F, cin, kt, kf, strides):
    rng = np.random.default_rng(T)
    p = _conv_params(rng, kt, kf, cin, 8)
    x = rng.standard_normal((2, T, F, cin)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = layers.conv2d_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), strides,
                              torch.float32).numpy()
    for fn in (jl.conv2d_apply, jl.conv2d_blocked_apply):
        want = np.asarray(fn(jp, jnp.asarray(x), strides, jnp.float32))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_symmetric_padding_would_differ():
    """Guards the test above: a symmetric padding of the same output
    shape gives other values, so TF-SAME must pad the extra row after."""
    rng = np.random.default_rng(0)
    p = _conv_params(rng, 11, 41, 1, 4)
    x = rng.standard_normal((1, 20, 40, 1)).astype(np.float32)
    want = np.asarray(jl.conv2d_apply({k: jnp.asarray(v) for k, v in
                                       p.items()}, jnp.asarray(x), (2, 2),
                                      jnp.float32))
    sym = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(p["w"]).permute(3, 2, 0, 1), stride=(2, 2),
        padding=(5, 20)).permute(0, 2, 3, 1).numpy() + p["b"]
    assert sym.shape == want.shape
    assert np.abs(sym - want).max() > 1e-2


def _tiny_cfg(**model_kw):
    kw = dict(frontend="conv", conv_channels=(4, 3),
              conv_kernels=((5, 7), (3, 5)), conv_strides=((2, 2), (1, 2)),
              rnn_layers=2, rnn_units=8, bidirectional=True, dropout=0.0,
              compute_dtype="float32", use_pallas_rnn=False)
    kw.update(model_kw)
    return Config(features=FeatureConfig(n_mels=24, use_pallas=False),
                  model=ModelConfig(**kw))


@pytest.mark.parametrize("model_kw", [
    {}, {"bidirectional": False}, {"rnn_layers": 0},   # 0: flatten -> head
    {"frontend": "dense", "dense_layers": 2, "dense_units": 12,
     "bidirectional": False},
    {"rnn_type": "gru"}, {"rnn_type": "rnn"},          # conv + Bi-cell
    {"frontend": "dense", "dense_layers": 2, "dense_units": 12,
     "bidirectional": False, "rnn_type": "gru"},
    {"frontend": "dense", "dense_layers": 2, "dense_units": 12,
     "bidirectional": False, "rnn_type": "rnn"},
    # the conv forms the flags select (the cases above run the defaults,
    # both true): full band, the 2-D conv, and 32 channels, where conv 1
    # tiles onto 128 columns (the blocked form) and conv 2 does not
    {"conv_blocked_fwd": False}, {"conv_as_matmul": False},
    {"conv_channels": (32, 32)},
    {"conv_channels": (32, 32), "conv_blocked_fwd": False},
    {"conv_channels": (32, 32), "conv_as_matmul": False},
])
def test_encoder_matches_reference(model_kw):
    cfg = _tiny_cfg(**model_kw)
    F = cfg.features.feature_dim
    jparams = init_params(jax.random.PRNGKey(3), cfg.model, F)
    params = params_from_jax(_flatten(jparams))
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 23, F)).astype(np.float32)
    flens = np.array([23, 11, 1], np.int32)
    want, wlens = jax.jit(j_apply, static_argnums=3)(
        jparams, jnp.asarray(feats), jnp.asarray(flens), cfg.model)
    got, glens = apply_encoder(params, torch.from_numpy(feats),
                               torch.from_numpy(flens), cfg.model)
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("as_matmul,blocked,route", [
    (True, True, "conv2d_blocked_apply"), (True, False, "conv2d_matmul_apply"),
    (False, True, "conv2d_apply"), (False, False, "conv2d_apply")])
def test_conv_flags_choose_the_route(as_matmul, blocked, route, monkeypatch):
    """``conv_as_matmul`` / ``conv_blocked_fwd`` pick the conv form as the
    reference's encoder does: every frontend layer goes through the chosen
    function and no other."""
    from ctc_asr_tpu_torch.models import encoder as enc
    calls = {}
    for name in ("conv2d_apply", "conv2d_matmul_apply",
                 "conv2d_blocked_apply"):
        def counted(*a, _fn=getattr(enc, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(enc, name, counted)
    cfg = _tiny_cfg(conv_as_matmul=as_matmul, conv_blocked_fwd=blocked)
    from ctc_asr_tpu_torch.models import init_params as t_init
    params = t_init(cfg.model, 24, torch.Generator().manual_seed(6))
    feats = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 15, 24)).astype(np.float32))
    apply_encoder(params, feats, torch.tensor([15, 7], dtype=torch.int32),
                  cfg.model)
    assert calls == {route: len(cfg.model.conv_strides)}


@pytest.mark.parametrize("model_kw,feat_dim", [
    ({}, 24), ({"bidirectional": False, "rnn_type": "gru"}, 13),
    ({"frontend": "dense", "rnn_type": "rnn"}, 26),
    ({"conv_kernels": ((11, 41), (11, 21)), "rnn_layers": 3}, 80),
])
def test_init_shapes_match_init_params(model_kw, feat_dim):
    cfg = _tiny_cfg(**model_kw).model
    tree = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg,
                                              feat_dim))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    want = {k: tuple(v.shape) for k, v in _flatten(tree).items()}
    assert init_shapes(cfg, feat_dim) == want


def test_output_lengths_match_reference():
    cfg = _tiny_cfg().model
    lens = np.array([0, 1, 2, 3, 798, 799], np.int32)
    from ctc_asr_tpu.models.encoder import output_lengths as j_out
    np.testing.assert_array_equal(
        output_lengths(torch.from_numpy(lens), cfg).numpy(),
        np.asarray(j_out(jnp.asarray(lens), cfg)))
    dense = dataclasses.replace(cfg, frontend="dense")
    np.testing.assert_array_equal(
        output_lengths(torch.from_numpy(lens), dense).numpy(), lens)
    with pytest.raises(ValueError, match="rnn_type"):
        init_shapes(dataclasses.replace(cfg, rnn_type="elman"), 24)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru", "rnn"])
def test_init_params_biases(rnn_type):
    """Zero biases for every cell but the LSTM's forget gate (1), as the
    reference's ``lstm_init`` / ``gru_init`` / ``vanilla_init``."""
    from ctc_asr_tpu_torch.models import init_params as t_init
    cfg = _tiny_cfg(rnn_type=rnn_type).model
    jparams = _flatten(init_params(jax.random.PRNGKey(0), cfg, 24))
    params = t_init(cfg, 24, torch.Generator().manual_seed(0))
    assert set(params) == set(jparams)
    for k, v in params.items():
        assert tuple(v.shape) == jparams[k].shape, k
        if k.endswith("/b"):
            np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]),
                                          err_msg=k)
    H = cfg.rnn_units
    assert params["rnn/0/fwd/b"].sum().item() == (H if rnn_type == "lstm"
                                                  else 0)


def test_kernel_switch_runs_the_gru_wrapper_and_leaves_the_vanilla_cell():
    """use_pallas_rnn sends the GRU through ``GruSeq`` / ``gru_seq`` (bf16
    recurrence: close to, not equal to, the plain path) and changes
    nothing for the vanilla cell, which has no kernel."""
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((2, 23, 24))
                             .astype(np.float32))
    flens = torch.tensor([23, 9], dtype=torch.int32)
    for rnn_type in ("gru", "rnn"):
        cfg = _tiny_cfg(rnn_type=rnn_type).model
        from ctc_asr_tpu_torch.models import init_params as t_init
        params = t_init(cfg, 24, torch.Generator().manual_seed(1))
        plain, _ = apply_encoder(params, feats, flens, cfg)
        kern, _ = apply_encoder(params, feats, flens, dataclasses.replace(
            cfg, use_pallas_rnn=True))
        if rnn_type == "rnn":
            assert torch.equal(kern, plain)
        else:
            assert not torch.equal(kern, plain)
            np.testing.assert_allclose(kern.numpy(), plain.numpy(),
                                       rtol=4e-2, atol=1e-2)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_width_without_a_plan_names_the_ways_out(rnn_type, monkeypatch):
    """Where ``plan_recurrence`` has no plan, the wrappers refuse a CUDA
    tensor before any launch with a message that names
    ``--model.use_pallas_rnn=false`` and a smaller batch: the port never
    gives way to the plain recurrence on the card by itself. Shown here on
    the H100's attributes at H = 1408 and on a card with 16 KB of shared
    memory a block; CPU tensors never consult the plan, so the kernel
    switch gives the same output on any device attributes."""
    from ctc_asr_tpu_torch.models import init_params as t_init
    from ctc_asr_tpu_torch.ops import lstm_cuda
    cpu = torch.device("cpu")
    gate_mult = {"lstm": 4, "gru": 3}[rnn_type]
    kcfg = dataclasses.replace(_tiny_cfg(rnn_type=rnn_type, rnn_units=16)
                               .model, use_pallas_rnn=True)
    params = t_init(kcfg, 24, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal((2, 23, 24))
                             .astype(np.float32))
    flens = torch.tensor([23, 9], dtype=torch.int32)
    before, _ = apply_encoder(params, feats, flens, kcfg)

    def refused(B, H):
        for backward in (False, True):
            with pytest.raises(ValueError, match="use_pallas_rnn=false.*"
                               "smaller --data.batch_size"):
                lstm_cuda.require_plan(cpu, 2, B, H, gate_mult, backward)

    refused(128, 1408)
    assert lstm_cuda.plan_for(cpu, 2, 2, 16, gate_mult) is not None
    monkeypatch.setattr(lstm_cuda, "device_limits",
                        lambda device: (132, 16 * 1024))
    refused(2, 16)
    after, _ = apply_encoder(params, feats, flens, kcfg)
    assert torch.equal(after, before)


def test_golden_tiny_model():
    """tests/golden/tiny_model.npz (the reference's frozen outputs):
    the port on the same samples and the same parameters. The file was
    made on the CPU, where the reference runs its f32 scan, so the port
    runs its plain f32 recurrence too (use_pallas_rnn=False)."""
    cfg = Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13, n_mels=26,
                               use_pallas=False),
        model=ModelConfig(frontend="dense", dense_layers=1,
                          dense_units=32, rnn_layers=1, rnn_units=32,
                          dropout=0.0, compute_dtype="float32",
                          use_pallas_rnn=False))
    rng = np.random.default_rng(12345)
    samples = (rng.standard_normal((2, int(0.6 * 16000))) * 0.2
               ).astype(np.float32)
    slens = np.array([samples.shape[1], samples.shape[1] // 2], np.int32)
    params = params_from_jax(_flatten(init_params(
        jax.random.PRNGKey(7), cfg.model, cfg.features.feature_dim)))
    feats, flens = tf.extract_features(torch.from_numpy(samples),
                                       torch.from_numpy(slens), cfg.features)
    logits, logit_lens = apply_encoder(params, feats, flens, cfg.model)
    ids, dlens = greedy_decode(logits, logit_lens)
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(feats.numpy(), z["feats"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(flens.numpy(), z["flens"])
        np.testing.assert_allclose(logits.numpy(), z["logits"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(logit_lens.numpy(), z["logit_lens"])
        np.testing.assert_array_equal(ids.numpy(), z["ids"])
        np.testing.assert_array_equal(dlens.numpy(), z["dlens"])
    # and the reference's own decoder on the port's logits
    jids, _ = j_greedy(jnp.asarray(logits.numpy()),
                        jnp.asarray(logit_lens.numpy()))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
