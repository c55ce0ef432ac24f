"""The optimizer of the train step: global-norm clipping, Adam / AdamW and
the learning-rate schedules, computed as optax computes them.

Counterpart of ``ctc_asr_tpu/train.py:38-62`` (``build_lr_schedule``,
``build_optimizer``): ``optax.chain(clip_by_global_norm(max),
adam(lr) | adamw(lr, weight_decay))``.

- Clipping is optax's: ``g`` is left alone while ``||g|| < max`` and
  becomes ``(g / ||g||) * max`` otherwise (``torch.nn.utils.
  clip_grad_norm_`` adds 1e-6 to the norm and is not used).
- Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  corrections ``1 - b^k`` in f32 with k the incremented count, update
  ``mu_hat / (sqrt(nu_hat) + eps)``; AdamW adds ``weight_decay * p``
  (decoupled), then the update is scaled by ``-lr``.
- The learning rate of step k is ``schedule(k)`` with k the count
  before the increment, as ``scale_by_schedule`` reads it.

Parameters and moments are flat dicts of f32 tensors keyed like the
encoder's parameters; the update is applied in place (the step keeps
one copy of the parameters and moments on the device). The count is a
Python int: the host knows the step, so the bias corrections and the
learning rate need no device round trip.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import TrainConfig
from .utils.profiling import span

# the profiler range around ``Adam.step``: the norm, the clip and every
# leaf's update
ADAM_RANGE = "optim.adam"


def lr_schedule(tcfg: TrainConfig):
    """Step count -> learning rate (``train.build_lr_schedule``)."""
    lr = tcfg.learning_rate
    if tcfg.lr_schedule == "constant":
        return lambda count: lr
    if tcfg.lr_schedule == "exponential":
        steps, rate = tcfg.lr_decay_steps, tcfg.lr_decay_rate
        if steps <= 0 or rate == 0:
            return lambda count: lr
        return lambda count: (lr if count <= 0
                              else lr * rate ** math.floor(count / steps))
    if tcfg.lr_schedule == "warmup_cosine":
        warmup = tcfg.warmup_steps
        decay = max(tcfg.total_steps, warmup + 1) - warmup

        def schedule(count):
            if count < warmup:      # linear from 0 to the peak
                return lr * min(max(count, 0), warmup) / warmup
            c = min(count - warmup, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return schedule
    raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (``optax.global_norm``),
    a 0-d f32 tensor on the leaves' device."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float())
                          for g in grads.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float,
                        gnorm: torch.Tensor) -> dict[str, torch.Tensor]:
    """optax.clip_by_global_norm, without a host round trip."""
    keep = gnorm < max_norm
    return {k: torch.where(keep, g, (g / gnorm) * max_norm)
            for k, g in grads.items()}


class Adam:
    """optax.chain([clip_by_global_norm], adam | adamw) over flat dicts.

    State: ``{"count": int, "mu": {k: tensor}, "nu": {k: tensor}}``."""

    def __init__(self, tcfg: TrainConfig):
        self.cfg = tcfg
        self.schedule = lr_schedule(tcfg)

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor], state: dict,
             gnorm: torch.Tensor | None = None) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads``;
        returns the global norm of the unclipped gradients. ``gnorm``,
        when given, is that norm computed by the caller (the
        tensor-parallel step's, over every rank's shards)."""
        with span(ADAM_RANGE):
            c = self.cfg
            if gnorm is None:
                gnorm = global_norm(grads)
            if c.grad_clip_norm > 0:
                grads = clip_by_global_norm(grads, c.grad_clip_norm, gnorm)
            count = state["count"] + 1
            # 1 - b**k in f32, as optax takes it: in double the
            # cancellation would give another f32 value (6e-6 relative
            # for b2 at k = 1)
            k = np.float32(count)
            bc1 = float(np.float32(1.0) - np.float32(c.adam_b1) ** k)
            bc2 = float(np.float32(1.0) - np.float32(c.adam_b2) ** k)
            lr = self.schedule(state["count"])
            for k, p in params.items():
                g = grads[k]
                mu, nu = state["mu"][k], state["nu"][k]
                mu.copy_((1.0 - c.adam_b1) * g + c.adam_b1 * mu)
                nu.copy_((1.0 - c.adam_b2) * (g * g) + c.adam_b2 * nu)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + c.adam_eps)
                if c.weight_decay > 0:
                    upd = upd + c.weight_decay * p
                p.add_(-lr * upd)
            state["count"] = count
            return gnorm
