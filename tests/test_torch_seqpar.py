"""The port's sequence parallelism (``ctc_asr_tpu_torch.parallel.seqpar``)
on the CPU, in this process: time chunks on CPU shards, held against the
reference's ``parallel/seqpar.py`` on the conftest's virtual CPU devices
(the functions of ``tests/test_seqpar.py``), at that file's tolerances.

- Features (``none`` / ``utterance`` / ``global``, and the int16 wire):
  the chunks' frames against the reference's, 2e-5.
- The wavefront bi-RNN for the LSTM, GRU and vanilla cells, and two
  stacked layers that chain with no resharding: 1e-5.
- The train step, dense and conv frontends, from the reference's
  initial state, two steps: loss 1e-5, gradient norm 1e-4, parameters
  rtol 2e-4 / atol 2e-5. With SpecAugment on, the reference draws JAX's
  random numbers, which torch cannot; there the SP step is held to the
  port's unsharded step with the same generator, at the same
  tolerances, and its masks really cut frames.
- The eval step on the conv config: 2e-5.
- The refusals: a feature-cache batch, a width the shards do not divide,
  a conv halo longer than a chunk, a chunk that is not a multiple of the
  stride or of the hop.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ctc_asr_tpu.checkpoint import _flatten
from ctc_asr_tpu.config import (Config, DataConfig, FeatureConfig,
                                ModelConfig, TrainConfig)
from ctc_asr_tpu.config import to_json
from ctc_asr_tpu.models.rnn import gru_init, lstm_init, vanilla_init
from ctc_asr_tpu.parallel import seqpar as j_sp
from ctc_asr_tpu_torch import checkpoint as t_ckpt
from ctc_asr_tpu_torch import train as t_train
from ctc_asr_tpu_torch.config import from_json
from ctc_asr_tpu_torch.optim import Adam
from ctc_asr_tpu_torch.parallel import seqpar as t_sp
from torch_threads import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def _port(jcfg):
    return from_json(to_json(jcfg))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["utterance", "none", "global"])
def test_sp_features_match_the_reference(norm):
    n = 4
    cfg = FeatureConfig(use_pallas=False, normalization=norm)
    hop, win = cfg.hop_length, cfg.win_length
    S, B = n * 10 * hop, 3
    rng = np.random.default_rng(0)
    samples = (rng.standard_normal((B, S)) * 0.2).astype(np.float32)
    slens = np.asarray([S, S - 3 * hop - 17, 2 * win], np.int32)
    want, want_lens = j_sp.make_sp_feature_fn(cfg, _mesh(n))(
        jnp.asarray(samples), jnp.asarray(slens))
    chunks, flens = t_sp.make_sp_feature_fn(_port(Config(features=cfg))
                                            .features, [CPU] * n)(
        _t(samples), _t(slens))
    assert len(chunks) == n and all(c.shape[1] == 10 for c in chunks)
    got = torch.cat(chunks, dim=1).numpy()
    np.testing.assert_array_equal(flens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    for b in range(B):
        assert np.all(got[b, int(flens[b]):] == 0.0)


def test_sp_features_int16_wire():
    n = 2
    cfg = FeatureConfig(use_pallas=False)
    S = n * 8 * cfg.hop_length
    rng = np.random.default_rng(1)
    wire = (rng.standard_normal((2, S)) * 3000).astype(np.int16)
    slens = np.asarray([S, S // 2], np.int32)
    want, _ = j_sp.make_sp_feature_fn(cfg, _mesh(n))(jnp.asarray(wire),
                                                     jnp.asarray(slens))
    chunks, _ = t_sp.make_sp_feature_fn(
        _port(Config(features=cfg)).features, [CPU] * n)(_t(wire),
                                                         _t(slens))
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the wavefront bi-RNN
# ---------------------------------------------------------------------------

def _birnn_params(cell, F, H, k0=0):
    init = {"lstm": lstm_init, "gru": gru_init, "rnn": vanilla_init}[cell]
    jp = {"fwd": init(jax.random.PRNGKey(k0), F, H),
          "bwd": init(jax.random.PRNGKey(k0 + 1), F, H)}
    return jp, {d: {k: _t(v) for k, v in p.items()} for d, p in jp.items()}


@pytest.mark.parametrize("cell,n,lens", [
    ("lstm", 4, [24, 17, 5]), ("lstm", 8, [24, 24, 1]),
    ("gru", 4, [24, 9, 24]), ("rnn", 4, [24, 9, 24])])
def test_sp_birnn_matches_the_reference(cell, n, lens):
    T, B, F, H = 24, 3, 5, 8
    jp, tp = _birnn_params(cell, F, H)
    x = jax.random.normal(jax.random.PRNGKey(2), (T, B, F))
    lengths = jnp.asarray(lens, jnp.int32)
    want = np.asarray(j_sp.make_sp_birnn_fn(jp, _mesh(n), cell=cell)(
        x, lengths))
    xs = list(_t(x).chunk(n))
    got = t_sp.make_sp_birnn_fn(tp, cell)(xs, _t(lengths))
    assert [g.shape for g in got] == [(T // n, B, 2 * H)] * n
    np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_sp_birnn_stack_two_layers():
    n = 4
    T, B, F, H = 16, 2, 6, 8
    jp1, tp1 = _birnn_params("lstm", F, H, 0)
    jp2, tp2 = _birnn_params("lstm", 2 * H, H, 2)
    x = jax.random.normal(jax.random.PRNGKey(4), (T, B, F))
    lengths = jnp.asarray([16, 11], jnp.int32)
    mesh = _mesh(n)
    want = j_sp.make_sp_birnn_fn(jp2, mesh)(
        j_sp.make_sp_birnn_fn(jp1, mesh)(x, lengths), lengths)
    f1, f2 = t_sp.make_sp_birnn_fn(tp1), t_sp.make_sp_birnn_fn(tp2)
    got = f2(f1(list(_t(x).chunk(n)), _t(lengths)),
             _t(lengths))
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the train and eval steps
# ---------------------------------------------------------------------------

def _sp_train_cfg(frontend="dense", specaugment=False):
    """``tests/test_seqpar.py::_sp_train_cfg`` (and ``_conv_cfg``)."""
    model = ModelConfig(frontend="dense", dense_layers=1, dense_units=32,
                        rnn_layers=2, rnn_units=16, bidirectional=True,
                        dropout=0.0, compute_dtype="float32",
                        use_pallas_rnn=False)
    if frontend == "conv":
        model = ModelConfig(frontend="conv", conv_channels=(8, 8),
                            conv_kernels=((11, 11), (11, 5)),
                            conv_strides=((2, 2), (1, 2)), rnn_layers=1,
                            rnn_units=16, bidirectional=True, dropout=0.0,
                            compute_dtype="float32", conv_as_matmul=False,
                            use_pallas_rnn=False)
    return Config(
        features=FeatureConfig(feature_type="mfcc", n_mfcc=13,
                               use_pallas=False),
        model=model,
        data=DataConfig(batch_size=2, num_buckets=1, num_workers=1),
        train=TrainConfig(learning_rate=1e-3, use_pallas_ctc=False,
                          specaugment=specaugment, sa_time_masks=2,
                          sa_freq_masks=2))


def _batch(cfg, n, hops):
    hop = cfg.features.hop_length
    B, S, U = 2, n * hops * hop, 12
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((B, S)) * 0.2).astype(np.float32),
            np.asarray([S, S - 5 * hop - 13], np.int32),
            rng.integers(0, 28, (B, U)).astype(np.int32),
            np.asarray([U, 7], np.int32))


def _port_state(jcfg):
    """The port's train state holding the reference's initial params."""
    from ctc_asr_tpu.train import init_train_state
    cfg = _port(jcfg)
    params = t_ckpt.params_from_jax(_flatten(jax.device_get(
        init_train_state(jcfg))))
    return cfg, t_train.state_from_parts(cfg, params,
                                         Adam(cfg.train).init(params), 0,
                                         {}, CPU)


def _jax_sp_steps(jcfg, n, batch, steps=2):
    from ctc_asr_tpu.train import init_train_state
    mesh = _mesh(n)
    state = jax.device_get(init_train_state(jcfg))
    step = j_sp.make_sp_train_step(jcfg, mesh, state, donate=False)
    state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    arrs = j_sp.sp_batch_put(mesh, batch)
    ms = []
    for _ in range(steps):
        state, m = step(state, *arrs)
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    return ms, t_ckpt.params_from_jax(_flatten(jax.device_get(
        {"params": state["params"]})))


def _check_steps(got_ms, want_ms, got_params, want_params):
    for (gl, gg), (wl, wg) in zip(got_ms, want_ms):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gg, wg, rtol=1e-4, atol=1e-5)
    assert sorted(got_params) == sorted(want_params)
    for k in want_params:
        np.testing.assert_allclose(got_params[k].detach().numpy(),
                                   want_params[k].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("frontend,n,hops", [("dense", 4, 8),
                                             ("conv", 2, 32)])
def test_sp_train_step_matches_the_reference(frontend, n, hops):
    jcfg = _sp_train_cfg(frontend)
    batch = _batch(jcfg, n, hops)
    want_ms, want_params = _jax_sp_steps(jcfg, n, batch)
    cfg, state = _port_state(jcfg)
    step = t_sp.make_sp_train_step(cfg, [CPU] * n)
    got_ms = [(float(m["loss"]), float(m["grad_norm"])) for m in
              (step(state, *map(_t, batch)) for _ in range(2))]
    _check_steps(got_ms, want_ms, state["params"], want_params)


@pytest.mark.parametrize("frontend,n,hops", [("dense", 4, 8),
                                             ("conv", 2, 32)])
def test_sp_train_step_with_specaugment_matches_the_unsharded(frontend, n,
                                                              hops):
    """SpecAugment over global frame indices: the SP step equals the
    port's unsharded step drawing from the same generator, and the masks
    change the loss."""
    jcfg = _sp_train_cfg(frontend, specaugment=True)
    batch = [_t(a) for a in _batch(jcfg, n, hops)]
    runs = {}
    for name in ("unsharded", "sp", "no_sa"):
        cfg, state = _port_state(jcfg)
        if name == "no_sa":
            cfg = dc.replace(cfg, train=dc.replace(cfg.train,
                                                   specaugment=False))
        step = (t_train.make_step_fn(cfg) if name == "unsharded" else
                t_sp.make_sp_train_step(cfg, [CPU] * n))
        ms = [(float(m["loss"]), float(m["grad_norm"])) for m in
              (step(state, *batch) for _ in range(2))]
        runs[name] = (ms, state["params"])
    (want_ms, want_p), (got_ms, got_p) = runs["unsharded"], runs["sp"]
    _check_steps(got_ms, want_ms, got_p, {k: v.detach()
                                          for k, v in want_p.items()})
    assert abs(runs["no_sa"][0][0][0] / got_ms[0][0] - 1) > 1e-3


def test_sp_eval_step_matches_the_reference():
    from ctc_asr_tpu.train import init_train_state
    n = 4
    jcfg = _sp_train_cfg("conv")
    hop = jcfg.features.hop_length
    B, S = 3, n * 32 * hop
    rng = np.random.default_rng(2)
    samples = (rng.standard_normal((B, S)) * 0.2).astype(np.float32)
    slens = np.asarray([S, S - 3 * hop - 5, S // 2], np.int32)
    mesh = _mesh(n)
    cfg, state = _port_state(jcfg)
    jparams = jax.device_get(init_train_state(jcfg))["params"]
    want, want_lens = j_sp.make_sp_eval_step(jcfg, mesh)(
        jparams, *j_sp.sp_batch_put(mesh, (samples, slens)))
    got, got_lens = t_sp.make_sp_eval_step(cfg, [CPU] * n)(
        {k: v.detach() for k, v in state["params"].items()},
        _t(samples), _t(slens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

def test_sp_refusals():
    n = 2
    feats = np.zeros((2, 32, 13), np.float16)
    for put, mesh in ((t_sp.sp_batch_put, [CPU] * n),
                      (j_sp.sp_batch_put, _mesh(n))):
        with pytest.raises(NotImplementedError, match="feature-cache"):
            put(mesh, (feats, np.array([32, 32], np.int32)))
        with pytest.raises(ValueError, match="not divisible by seq_axis=2"):
            put(mesh, (np.zeros((2, 161), np.float32),
                       np.array([161, 161], np.int32)))
    cfg = _port(_sp_train_cfg("conv"))
    fcfg = cfg.features
    with pytest.raises(ValueError, match="must be a hop multiple"):
        t_sp.sp_features([torch.zeros(2, 170)] * 2,
                         torch.tensor([340, 340]), fcfg)
    layer = {"w": torch.zeros(11, 5, 1, 4), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="not divisible by time stride 2"):
        t_sp.sp_conv_layer(layer, [torch.zeros(1, 7, 13, 1)] * 2, (2, 2),
                           (11, 5), torch.float32)
    with pytest.raises(ValueError, match="halo .* exceeds the local chunk"):
        t_sp.sp_conv_layer(layer, [torch.zeros(1, 4, 13, 1)] * 2, (1, 2),
                           (11, 5), torch.float32)
