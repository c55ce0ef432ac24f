"""The numbers that decide ``correct``, each against its limit in the
cell's file (``cells/<name>.json``).

Training (the first three steps of the one train state the window then
uses, against the reference's three steps from the same start):

- ``loss_gap``: the worst step's |loss - reference| / |reference|;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  clipped gradient (the program's from its Adam state after one step,
  mu / (1 - b1)) and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same for the change of the parameters over the
  three steps, over the leaves whose first reference gradient is at
  least a thousandth of the median leaf's (a leaf nought to rounding
  moves under Adam by round-off alone).

Decoding (``drivers/decode.py`` ``judge``, over a sample of the window's
batches): ``frame_gap``, how far the reference's log-posterior of the
program's top class lies below the reference's best at the worst frame;
``dist_gap``, the largest total-variation distance between the two
posteriors at a frame; ``answer_gap``, the widest gap in nats by which an
answer's decode objective lies below the reference's best
(``reference.decode``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in d.items()}


def _worst(prog: dict, ref: dict, keys) -> tuple[float, str]:
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def train_readings(prog: dict, ref: dict, params0: dict, b1: float) -> dict:
    """``prog``: {"losses", "mu1" (Adam's first moment after step 1),
    "params" (after step 3)}; ``ref``: reference.train_steps's result;
    ``params0``: the common start. Tensors on any device."""
    dev = ref["params"][next(iter(ref["params"]))].device
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    g_prog = _norms({k: v.to(dev) / (1.0 - b1)
                     for k, v in prog["mu1"].items()})
    g_ref = _norms(ref["grads1"])
    grad_gap, grad_leaf = _worst(g_prog, g_ref, g_ref)
    med = float(np.median(list(g_ref.values())))
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    d_prog = _norms({k: prog["params"][k].to(dev) - params0[k].to(dev)
                     for k in moving})
    d_ref = _norms({k: ref["params"][k] - params0[k].to(dev)
                    for k in moving})
    change_gap, change_leaf = _worst(d_prog, d_ref, moving)
    return {"loss_gap": max(losses) if losses else math.inf,
            "grad_gap": grad_gap, "change_gap": change_gap,
            "_leaves": {"grad": grad_leaf, "change": change_leaf,
                        "excluded": sorted(set(g_ref) - set(moving))}}


def checks(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Every reading beside its limit; correct when each is finite and
    at most its limit."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name, math.inf)
        v = float(v) if v is not None else math.inf
        ok = ok and math.isfinite(v) and v <= limit
        out[name] = {"value": v, "limit": limit}
    return ok, out
