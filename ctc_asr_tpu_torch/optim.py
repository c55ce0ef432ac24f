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
learning rate need no device round trip. Every operation of the update
takes all the leaves at once (``torch._foreach_*``), and where the
parameters and moments tile one buffer each (``flat_leaves``, as
``train.state_from_parts`` lays them out) it is one operation on that
buffer: a model of many leaves (the Conformer has 670) then costs the
host a few operations a step, not a few per leaf.
"""

from __future__ import annotations

import itertools
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
    a 0-d f32 tensor on the leaves' device. On the card the leaves'
    norms come from one multi-tensor kernel and the result is their norm
    (a sum per leaf would cost three launches a leaf); elsewhere the
    leaves' sums of squares are added in order, as optax adds them."""
    gs = [g.float() for g in grads.values()]
    if gs and gs[0].is_cuda:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    return torch.sqrt(sum(torch.sum(s) for s in torch._foreach_mul(gs, gs)))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        gnorm: torch.Tensor) -> list[torch.Tensor]:
    """optax.clip_by_global_norm, without a host round trip."""
    keep = gnorm < max_norm
    scaled = torch._foreach_div(grads, gnorm)
    torch._foreach_mul_(scaled, max_norm)
    return [torch.where(keep, g, c) for g, c in zip(grads, scaled)]


def flat_leaves(tensors: dict[str, torch.Tensor],
                device) -> dict[str, torch.Tensor]:
    """f32 copies of ``tensors`` on ``device`` that tile one contiguous
    buffer in the dict's order, each a tensor of its own over its slice
    of the buffer's storage (not a view, so that each can be a leaf)."""
    total = sum(t.numel() for t in tensors.values())
    storage = torch.empty(total, dtype=torch.float32,
                          device=device).untyped_storage()
    out, at = {}, 0
    for k, t in tensors.items():
        out[k] = torch.empty(0, dtype=torch.float32, device=device).set_(
            storage, at, tuple(t.shape)).copy_(t)
        at += t.numel()
    return out


def _tiled(ts: list[torch.Tensor]) -> torch.Tensor | None:
    """The one contiguous f32 buffer that ``ts`` tile in order, as a flat
    tensor over its storage; None where they do not."""
    if not ts:
        return None
    storage = ts[0].untyped_storage()
    at = 0
    for t in ts:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.storage_offset() != at
                or t.untyped_storage().data_ptr() != storage.data_ptr()):
            return None
        at += t.numel()
    if storage.nbytes() != 4 * at:
        return None
    return torch.empty(0, dtype=torch.float32, device=ts[0].device).set_(
        storage, 0, (at,))


class Adam:
    """optax.chain([clip_by_global_norm], adam | adamw) over flat dicts.

    State: ``{"count": int, "mu": {k: tensor}, "nu": {k: tensor}}``."""

    def __init__(self, tcfg: TrainConfig):
        self.cfg = tcfg
        self.schedule = lr_schedule(tcfg)
        self._buffers = None    # (the tiled tensors, their buffers)

    def _flat(self, *lists):
        """Each list's buffer where every list tiles one (``_tiled``), else
        None; kept for the same tensors, which it holds."""
        held = self._buffers
        if held is not None and len(held[0]) == sum(map(len, lists)) and \
                all(a is b for a, b in zip(held[0], itertools.chain(*lists))):
            return held[1]
        bufs = [_tiled(ts) for ts in lists]
        if any(b is None for b in bufs):
            return None
        self._buffers = (list(itertools.chain(*lists)), bufs)
        return bufs

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
            keys = list(params)
            ps = [params[k] for k in keys]
            g = [grads[k] for k in keys]
            mu = [state["mu"][k] for k in keys]
            nu = [state["nu"][k] for k in keys]
            flat = self._flat(ps, mu, nu)
            if flat is not None:
                ps, mu, nu = ([b] for b in flat)
                g = [torch.cat([t.reshape(-1) for t in g])]
            if c.grad_clip_norm > 0:
                g = clip_by_global_norm(g, c.grad_clip_norm, gnorm)
            count = state["count"] + 1
            # 1 - b**k in f32, as optax takes it: in double the
            # cancellation would give another f32 value (6e-6 relative
            # for b2 at k = 1)
            k = np.float32(count)
            bc1 = float(np.float32(1.0) - np.float32(c.adam_b1) ** k)
            bc2 = float(np.float32(1.0) - np.float32(c.adam_b2) ** k)
            lr = self.schedule(state["count"])
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, c.adam_b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - c.adam_b1))
            gg = torch._foreach_mul(g, g)
            torch._foreach_mul_(gg, 1.0 - c.adam_b2)
            torch._foreach_mul_(nu, c.adam_b2)
            torch._foreach_add_(nu, gg)
            # (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd p], times -lr
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, c.adam_eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            if c.weight_decay > 0:
                torch._foreach_add_(upd, torch._foreach_mul(ps,
                                                            c.weight_decay))
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(ps, upd)
            state["count"] = count
            return gnorm
