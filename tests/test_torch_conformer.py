"""The port's Conformer (``models/conformer.py``) on the CPU at a tiny size,
held to the benchmark's plain float32 reference of the same model
(``asrbench/reference/conformer.py``, NeMo's modules written down once
more): logits, loss, gradients and three AdamW steps in f32, and the
bf16 path within a tolerance that float8 operands exceed. Besides: the
relative shift against a direct (i - j) gather, a row's eval output
against another row's padding, BatchNorm's running statistics, the
subsampled lengths, the attention counters and spans of the normal
path (no library attention), the checkpoint of the model state, and
``cli train`` / ``evaluate`` / ``transcribe`` from a configuration
file."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from asrbench import judge
from asrbench.reference import conformer as ref
from ctc_asr_tpu_torch import checkpoint as t_ckpt
from ctc_asr_tpu_torch import config as t_config
from ctc_asr_tpu_torch import train as t_train
from ctc_asr_tpu_torch.evaluate import make_eval_step
from ctc_asr_tpu_torch.features import extract_features
from ctc_asr_tpu_torch.models import conformer, encoder
from ctc_asr_tpu_torch.optim import Adam
from ctc_asr_tpu_torch.utils import profiling
from torch_threads import one_thread  # noqa: F401  (autouse)

B, S, U = 3, 16000, 10
LENS = (S, 12000, 9000)          # 98 / 73 / 54 frames -> 25 / 19 / 14


def _cfg(dtype: str = "float32", **model) -> t_config.Config:
    d = json.loads(t_config.to_json(t_config.Config()))
    d["model"] = {"frontend": "conformer", "d_model": 16, "n_heads": 2,
                  "n_layers": 2, "conv_kernel": 5, "subsampling_channels": 4,
                  "dropout": 0.0, "compute_dtype": dtype, **model}
    d["features"]["use_pallas"] = False
    d["train"].update(use_pallas_ctc=False, learning_rate=1e-3,
                      adam_b2=0.98, weight_decay=1e-3, grad_clip_norm=0.0)
    return t_config.from_json(json.dumps(d))


def _as_dict(cfg) -> dict:
    return json.loads(t_config.to_json(cfg))


def _params(cfg, seed: int = 7) -> dict:
    return encoder.init_params(cfg.model, cfg.features.feature_dim,
                               torch.Generator().manual_seed(seed))


def _batch(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"samples": torch.randint(-3000, 3000, (B, S), generator=g,
                                     dtype=torch.int16),
            "sample_lengths": torch.tensor(LENS, dtype=torch.int32),
            "labels": torch.randint(0, 27, (B, U), generator=g,
                                    dtype=torch.int32),
            "label_lengths": torch.tensor([U, 8, 5], dtype=torch.int32)}


def _port_steps(cfg, params0: dict, batches: list) -> dict:
    """The port's train steps from ``params0``: the judge's view of them
    (losses, Adam's first moment after step 1, parameters after the
    last) and the state."""
    state = t_train.state_from_parts(
        cfg, {k: v.clone() for k, v in params0.items()},
        Adam(cfg.train).init(params0), 0, {}, torch.device("cpu"))
    step = t_train.make_step_fn(cfg)
    losses, mu1 = [], None
    for i, b in enumerate(batches):
        losses.append(float(step(state, b["samples"], b["sample_lengths"],
                                 b["labels"], b["label_lengths"])["loss"]))
        if i == 0:
            mu1 = {k: v.clone() for k, v in state["opt_state"]["mu"].items()}
    return {"losses": losses, "mu1": mu1,
            "params": {k: v.detach() for k, v in state["params"].items()},
            "state": state}


@pytest.fixture(scope="module")
def f32_run():
    torch.manual_seed(0)
    cfg = _cfg()
    params0 = _params(cfg)
    batches = [_batch(i) for i in range(3)]
    want = ref.train_steps(params0, batches, _as_dict(cfg))
    got = _port_steps(cfg, params0, batches)
    return cfg, params0, batches, want, got


# the tolerances of the f32 comparison: the same operations on the same
# inputs in another order (fused LayerNorm and BatchNorm kernels, the
# strided shift against NeMo's padded copy) differ by f32 round-off
LOGIT_TOL = 1e-4          # absolute, logits of magnitude ~10
LOSS_TOL = 1e-5           # relative
GRAD_TOL = 1e-4           # the judge's grad_gap
# Adam's steps turn a gradient entry that is round-off (a key bias, the
# depthwise bias BatchNorm cancels, the rows of W_pos that meet the
# near-constant position columns, which the softmax cancels) into a step
# of about lr whose sign round-off decides; the judge's change_gap
# leaves the first two out, and the last moves its leaf's norm (7e-4
# here)
CHANGE_TOL = 5e-3


@pytest.mark.parametrize("what", ["logits", "loss", "grads", "steps"])
def test_port_matches_reference_f32(f32_run, what):
    cfg, params0, batches, want, got = f32_run
    b = batches[0]
    if what == "logits":
        with torch.no_grad():
            feats, flens = extract_features(b["samples"],
                                            b["sample_lengths"],
                                            cfg.features)
            state = encoder.init_state(cfg.model)
            lg, lens = encoder.apply_encoder({**params0, **state}, feats,
                                             flens, cfg.model)
        rl, rlens = ref.logits(params0, b["samples"], b["sample_lengths"],
                               _as_dict(cfg))
        assert torch.equal(lens.long(), rlens.long())
        assert float((lg - rl).abs().max()) < LOGIT_TOL
        assert float(rl.abs().max()) > 1.0
    elif what == "loss":
        assert got["losses"][0] == pytest.approx(want["losses"][0],
                                                 rel=LOSS_TOL)
    else:
        r = judge.train_readings(got, want, params0, cfg.train.adam_b1)
        if what == "grads":
            assert r["grad_gap"] < GRAD_TOL
        else:
            assert got["losses"] == pytest.approx(want["losses"],
                                                  rel=LOSS_TOL)
            assert r["change_gap"] < CHANGE_TOL


@pytest.mark.parametrize("model", [{"untie_biases": False},
                                   {"xscaling": False},
                                   {"subsampling_factor": 8},
                                   {"subsampling_factor": 2}])
def test_variants_match_reference_f32(model):
    """The options the Large row leaves at one value: shared u / v
    biases, no x-scaling, a deeper and a shallower subsampling; a step's
    loss and gradients and the eval logits against the reference."""
    cfg = _cfg(**model)
    params0 = _params(cfg)
    b = _batch(4)
    want = ref.train_steps(params0, [b], _as_dict(cfg))
    got = _port_steps(cfg, params0, [b])
    assert got["losses"][0] == pytest.approx(want["losses"][0],
                                             rel=LOSS_TOL)
    r = judge.train_readings(got, want, params0, cfg.train.adam_b1)
    assert r["grad_gap"] < GRAD_TOL
    ev = make_eval_step(cfg, "cpu")
    lg, _ = ev({**params0, **encoder.init_state(cfg.model)}, b["samples"],
               b["sample_lengths"])
    rl, _ = ref.logits(params0, b["samples"], b["sample_lengths"],
                       _as_dict(cfg))
    assert float((lg - rl).abs().max()) < LOGIT_TOL


# the bf16 path: operands rounded at 2^-9 relative move the gradients by
# under 1% at this size (6e-3); float8 e4m3 operands (2^-4) by 15%
BF16_GRAD_TOL = 0.03


def test_bf16_path_within_a_tolerance_fp8_exceeds(f32_run):
    _, params0, batches, want, _ = f32_run
    cfg = _cfg("bfloat16")
    got = _port_steps(cfg, params0, batches[:1])
    bf16 = judge.train_readings(got, want, params0, cfg.train.adam_b1)
    fp8 = ref.train_steps(params0, batches[:1], _as_dict(cfg), quant="fp8")
    fp8 = judge.train_readings(
        {"losses": fp8["losses"], "params": fp8["params"],
         "mu1": {k: v * (1 - cfg.train.adam_b1)
                 for k, v in fp8["grads1"].items()}},
        want, params0, cfg.train.adam_b1)
    assert bf16["grad_gap"] < BF16_GRAD_TOL < fp8["grad_gap"]


def test_rel_shift_is_the_i_minus_j_gather():
    """rel_shift's (i, j) is column (T-1) - i + j, the score against
    position i - j; and NeMo's pad-and-view shift, cropped, agrees."""
    g = torch.Generator().manual_seed(3)
    T, dk = 7, 4
    q = torch.randn(2, 3, T, dk, generator=g)
    p = torch.randn(3, 2 * T - 1, dk, generator=g)  # row r: position T-1-r
    bd = torch.matmul(q, p.transpose(-2, -1)).contiguous()
    got = conformer.rel_shift(bd)
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    rows = (T - 1) - (i - j)                        # position i - j
    direct = torch.einsum("bhid,hijd->bhij", q, p[:, rows])
    assert torch.allclose(got, direct, atol=1e-5)
    assert torch.equal(got, ref.nemo_rel_shift(bd)[..., :T])


def test_eval_row_ignores_other_rows_padding():
    cfg = _cfg()
    params = {**_params(cfg), **encoder.init_state(cfg.model)}
    g = torch.Generator().manual_seed(5)
    feats = torch.randn(2, 120, 80, generator=g)
    outs = []
    for other in (40, 120, 100):
        f = feats.clone()
        f[1, other:] = 0.0
        with torch.no_grad():
            lg, lens = encoder.apply_encoder(
                params, f, torch.tensor([60, other]), cfg.model)
        outs.append(lg[0, :lens[0]])
    for o in outs[1:]:
        assert torch.allclose(o, outs[0], atol=1e-5)


def test_batchnorm_running_statistics(monkeypatch):
    """Each train step moves the running statistics by the momentum
    towards the batch's (the variance unbiased); eval reads them, from
    the state or from the parameters, as the reference does."""
    cfg = _cfg()
    m = cfg.model.bn_momentum
    params0 = _params(cfg)
    state = t_train.state_from_parts(cfg, dict(params0),
                                     Adam(cfg.train).init(params0), 0, {},
                                     torch.device("cpu"))
    assert all(float(v.sum()) == (0.0 if k.endswith("mean") else 16.0)
               for k, v in state["model_state"].items())
    seen = []
    real = F.batch_norm

    def spy(x, *args, **kw):
        if kw.get("training"):
            seen.append(x.detach().clone())
        return real(x, *args, **kw)
    monkeypatch.setattr(F, "batch_norm", spy)
    step = t_train.make_step_fn(cfg)
    mean = torch.zeros(16)
    var = torch.ones(16)
    for i in range(2):
        b = _batch(i)
        seen.clear()
        step(state, b["samples"], b["sample_lengths"], b["labels"],
             b["label_lengths"])
        x = seen[0]                                  # layer 0's input
        mean = (1 - m) * mean + m * x.mean(0)
        var = (1 - m) * var + m * x.var(0, unbiased=True)
    assert torch.allclose(state["model_state"]["layers/0/conv/bn/mean"],
                          mean, atol=1e-6)
    assert torch.allclose(state["model_state"]["layers/0/conv/bn/var"],
                          var, atol=1e-5)
    monkeypatch.setattr(F, "batch_norm", real)
    b = _batch(0)
    params = {k: v.detach() for k, v in state["params"].items()}
    ev = make_eval_step(cfg, "cpu")
    lg, _ = ev({**params, **state["model_state"]}, b["samples"],
               b["sample_lengths"])
    fresh, _ = ev({**params, **encoder.init_state(cfg.model)}, b["samples"],
                  b["sample_lengths"])
    want, _ = ref.logits({**params, **state["model_state"]}, b["samples"],
                         b["sample_lengths"], _as_dict(cfg))
    assert float((lg - want).abs().max()) < LOGIT_TOL
    assert float((lg - fresh).abs().max()) > 100 * LOGIT_TOL


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_subsampled_lengths(factor):
    cfg = _cfg(subsampling_factor=factor)
    frames = torch.arange(1, 60)
    got = conformer.output_lengths(frames, cfg.model)
    assert torch.equal(got.long(), ref.subsampled_lengths(
        frames, _as_dict(cfg)["model"]))
    want = frames.clone()
    for _ in range({2: 1, 4: 2, 8: 3}[factor]):
        want = (want - 1) // 2 + 1                   # a 3x3, stride-2 conv
    assert torch.equal(got.long(), want)
    params = _params(cfg)
    with torch.no_grad():
        x = conformer._subsample(params, torch.zeros(1, 59, 80), cfg.model,
                                 torch.float32)
    assert x.shape[1] == int(want[-1])
    d = _as_dict(cfg)
    assert ref.encoder_frames(16000, d) == int(conformer.output_lengths(
        torch.tensor([98]), cfg.model))


def test_normal_path_spans_counters_and_no_library_attention(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the port called a library attention")
    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    cfg = _cfg()
    state = t_train.init_train_state(cfg)
    step = t_train.make_step_fn(cfg)
    b = _batch(1)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, b["samples"], b["sample_lengths"], b["labels"],
             b["label_lengths"])
    after = profiling.counters()
    names = {e.name for e in prof.events()}
    assert {conformer.SUBSAMPLING_RANGE, conformer.FFN_RANGE,
            conformer.ATTENTION_RANGE, conformer.CORE_RANGE,
            conformer.CONV_RANGE, t_train.STEP_RANGE} <= names
    T, H, L = 25, 2, 2
    lens = torch.tensor([25, 19, 14])

    def grew(name):
        return after.get(name, 0) - before.get(name, 0)
    assert grew(conformer.ENTRIES_COUNTER) == L * B * H * T * T
    assert grew(conformer.REAL_ENTRIES_COUNTER) == \
        L * H * int((lens ** 2).sum())


def test_checkpoint_keeps_the_model_state(tmp_path):
    cfg = _cfg()
    state = t_train.init_train_state(cfg)
    step = t_train.make_step_fn(cfg)
    b = _batch(2)
    step(state, b["samples"], b["sample_lengths"], b["labels"],
         b["label_lengths"])
    path = t_ckpt.save_checkpoint(str(tmp_path), 1,
                                  t_train.state_to_flat(cfg, state),
                                  process_index=0)
    flat, _ = t_ckpt.restore_latest(str(tmp_path))
    back = t_train.state_from_parts(
        cfg, *t_ckpt.state_from_flat(flat, cfg), torch.device("cpu"),
        t_ckpt.model_state_from_flat(flat, cfg))
    for part in ("params", "model_state"):
        assert set(back[part]) == set(state[part])
        for k, v in state[part].items():
            assert torch.equal(back[part][k], v.detach()), k
    loaded = t_ckpt.load_params(path, cfg)
    assert set(loaded) == set(state["params"]) | set(state["model_state"])
    assert not torch.equal(loaded["layers/1/conv/bn/var"],
                           torch.ones(16))
    with pytest.raises(KeyError):
        t_ckpt.model_state_from_flat(
            {k: v for k, v in flat.items() if "bn/var" not in k}, cfg)


def test_config_selects_the_conformer_and_refuses_other_meshes():
    cfg = _cfg()
    assert isinstance(cfg.model, t_config.ConformerModelConfig)
    assert t_config.from_json(t_config.to_json(cfg)) == cfg
    over = t_config.apply_overrides(cfg, {"model.n_layers": "3"})
    assert over.model.n_layers == 3 and over.model.d_model == 16
    big = t_config.apply_overrides(t_config.Config(),
                                   {"model.frontend": "conformer"})
    # the fields the two kinds share keep the RNN config's values
    assert big.model == t_config.ConformerModelConfig(dropout=0.05)
    assert type(t_config.preset("deepspeech_beam").model) is \
        t_config.ModelConfig
    for key in ("mesh.seq_axis", "mesh.model_axis"):
        with pytest.raises(NotImplementedError):
            t_train.check_regime(t_config.apply_overrides(cfg, {key: "2"}))


def test_cli_train_evaluate_transcribe(tmp_path, capsys):
    from ctc_asr_tpu_torch import cli
    from ctc_asr_tpu_torch.data.synth import generate_corpus
    manifest = generate_corpus(str(tmp_path / "synth"), num_utterances=4,
                               seed=3)
    d = _as_dict(_cfg())
    d["data"].update(train_manifest=manifest, eval_manifest=manifest,
                     batch_size=2, num_buckets=1, num_workers=1)
    d["train"].update(train_dir=str(tmp_path / "run"), eval_every=2,
                      log_every=1, checkpoint_every=2)
    path = tmp_path / "conformer.json"
    path.write_text(json.dumps(d))
    assert cli.main(["train", "--config", str(path), "--device=cpu",
                     "--max-steps", "2"]) == 0
    ckpt = str(tmp_path / "run")
    assert cli.main(["evaluate", "--config", str(path), "--ckpt", ckpt,
                     "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert '"wer"' in out
    with open(manifest) as f:
        wav = f.readline().split(";")[0]
    assert cli.main(["transcribe", "--config", str(path), "--ckpt", ckpt,
                     "--device=cpu", wav]) == 0
    assert wav in capsys.readouterr().out
    z = np.load(t_ckpt.latest_checkpoint(ckpt + "/ckpt"))
    assert "batch_stats/layers/0/conv/bn/mean" in z.files
