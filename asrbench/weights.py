"""Seeded parameters of a configuration, made on the device in one call.

The keys, layouts and order are the family's (``param_shapes``), and so
are the starting values of the leaves that are not drawn
(``init_fixed``: biases). Every other leaf is Glorot-uniform, cut from
one ``torch.rand`` on a generator of the device in the order of the
shapes, as a fresh model is initialised. Both the program and the
reference are handed these same values.

The decode cells shape these further (``drivers.decode.decode_params``).
"""

from __future__ import annotations

import math

import torch

from .traffic import sub_seed


def make_params(family, cfg: dict, seed: int, device) -> dict:
    """f32 parameters of ``family``'s model on ``device`` from ``seed``."""
    device = torch.device(device)
    shp = family.param_shapes(cfg)
    fixed = {k: family.init_fixed(k, s, cfg, device) for k, s in shp.items()}
    n = sum(math.prod(shp[k]) for k, v in fixed.items() if v is None)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 10))
    flat = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    params, at = {}, 0
    for k, s in shp.items():
        v = fixed[k]
        if v is None:
            size = math.prod(s)
            fan_in, fan_out = s[-2], s[-1]
            if len(s) > 2:
                rf = math.prod(s[:-2])
                fan_in, fan_out = fan_in * rf, fan_out * rf
            v = flat[at:at + size].view(s).mul(
                math.sqrt(6.0 / (fan_in + fan_out)))
            at += size
        params[k] = v
    del flat
    return params
