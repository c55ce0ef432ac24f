"""The port's optimizer (ctc_asr_tpu_torch.optim) held against optax as
the reference builds it (``train.build_optimizer`` /
``build_lr_schedule``).

The same numpy gradient sequence goes to both for 20 steps. Gradient
scales alternate around the clip threshold so both branches of
``clip_by_global_norm`` run. Parameters, moments and the learning rate
of every step must agree to 1e-6 relative (f32 arithmetic; the
schedules are taken in double on the host and rounded once). A
parameter near 0 moves by up to the learning rate in a step, so its
absolute tolerance is 1e-6 of the learning rate (a few f32 ulps of the
update); a moment near 0 is a cancelling sum, held to 1e-6 of its
leaf's largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from ctc_asr_tpu.config import TrainConfig
from ctc_asr_tpu.train import build_lr_schedule, build_optimizer
from ctc_asr_tpu_torch import optim

REL = 1e-6
SHAPES = {"a/w": (5, 7), "a/b": (7,), "c": (3, 2, 4)}
STEPS = 20


def _run(tcfg: TrainConfig, seed: int):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    # scale alternates: global norms from ~0.3x to ~3x grad_clip_norm
    grads = []
    for i in range(STEPS):
        scale = [0.02, 0.3, 1.0, 0.05][i % 4]
        grads.append({k: (scale * rng.standard_normal(s)).astype(np.float32)
                      for k, s in SHAPES.items()})

    tx = build_optimizer(tcfg)
    sched = build_lr_schedule(tcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = optim.Adam(tcfg)
    ts = opt.init(tp)
    norms = []
    for i, g in enumerate(grads):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, js = tx.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(opt.schedule(i), float(sched(i)),
                                   rtol=REL, atol=1e-12)
        gn = opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        norms.append(gn.item())
        np.testing.assert_allclose(gn.item(), float(optax.global_norm(jg)),
                                   rtol=REL)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=REL,
                                       atol=REL * tcfg.learning_rate,
                                       err_msg=f"step {i} {k}")
    adam = js[-1][0]
    assert ts["count"] == int(adam.count) == STEPS
    for k in SHAPES:
        for part in ("mu", "nu"):
            # a moment near 0 is a cancelling sum: 1e-6 of its leaf's scale
            want = np.asarray(getattr(adam, part)[k])
            np.testing.assert_allclose(ts[part][k].numpy(), want, rtol=REL,
                                       atol=REL * np.abs(want).max(),
                                       err_msg=f"{part} {k}")
    return norms


@pytest.mark.parametrize("schedule,extra", [
    ("constant", {}),
    ("exponential", {"lr_decay_steps": 3, "lr_decay_rate": 0.5}),
    ("warmup_cosine", {"warmup_steps": 5, "total_steps": 15}),
])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_matches_optax(schedule, extra, weight_decay):
    tcfg = TrainConfig(learning_rate=3e-3, lr_schedule=schedule,
                       grad_clip_norm=1.0, weight_decay=weight_decay, **extra)
    norms = _run(tcfg, seed=len(schedule))
    assert min(norms) < 1.0 < max(norms)          # both clip branches ran


def test_no_clip_matches_optax():
    _run(TrainConfig(learning_rate=1e-2, grad_clip_norm=0.0), seed=3)


def test_warmup_cosine_edges():
    """decay_steps = max(total, warmup + 1); warmup 0 starts at the peak."""
    for tcfg in (TrainConfig(lr_schedule="warmup_cosine", warmup_steps=10,
                             total_steps=4, learning_rate=1.0),
                 TrainConfig(lr_schedule="warmup_cosine", warmup_steps=0,
                             total_steps=8, learning_rate=1.0)):
        mine, ref = optim.lr_schedule(tcfg), build_lr_schedule(tcfg)
        for k in range(0, 30):
            np.testing.assert_allclose(mine(k), float(ref(k)), rtol=REL,
                                       atol=1e-7)
    with pytest.raises(ValueError, match="lr_schedule"):
        optim.lr_schedule(dataclasses.replace(TrainConfig(),
                                              lr_schedule="linear"))
