"""Seeded parameters of a configuration, made on the device in one call.

The keys and layouts are the port's (``frontend/<i>/w [kt, kf, cin,
cout]``, ``rnn/<i>/<fwd|bwd>/wx [d, 4H]``, ``wh [H, 4H]``, ``b [4H]``,
``head/w [d, C]``, ``head/b [C]``); the values are Glorot-uniform weights
drawn by one ``torch.rand`` on a generator of the device, zero biases
and an LSTM forget-gate bias of 1, as a fresh model is initialised.
Both the program and the reference are handed these same values.

The decode cells shape these further (``drivers.decode.decode_params``).
"""

from __future__ import annotations

import math

import torch

from .traffic import sub_seed


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def shapes(cfg: dict) -> dict:
    m, feat = cfg["model"], cfg["features"]
    F = feat["n_mfcc"] if feat["feature_type"] == "mfcc" else feat["n_mels"]
    out = {}
    cin, f = 1, F
    for i, (ch, (kt, kf), (_st, sf)) in enumerate(zip(
            m["conv_channels"], m["conv_kernels"], m["conv_strides"])):
        out[f"frontend/{i}/w"] = (kt, kf, cin, ch)
        out[f"frontend/{i}/b"] = (ch,)
        cin, f = ch, _cdiv(f, sf)
    d = f * cin
    G = {"lstm": 4, "gru": 3, "rnn": 1}[m["rnn_type"]] * m["rnn_units"]
    dirs = ("fwd/", "bwd/") if m["bidirectional"] else ("",)
    for i in range(m["rnn_layers"]):
        for p in dirs:
            out[f"rnn/{i}/{p}wx"] = (d, G)
            out[f"rnn/{i}/{p}wh"] = (m["rnn_units"], G)
            out[f"rnn/{i}/{p}b"] = (G,)
        d = len(dirs) * m["rnn_units"]
    out["head/w"] = (d, m["num_classes"])
    out["head/b"] = (m["num_classes"],)
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """f32 parameters on ``device`` from ``seed``."""
    device = torch.device(device)
    shp = shapes(cfg)
    weights = [k for k in shp if not k.endswith("/b")]
    n = sum(math.prod(shp[k]) for k in weights)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 10))
    flat = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(2.0).sub_(1.0)
    params, at = {}, 0
    for k, s in shp.items():
        if k.endswith("/b"):
            v = torch.zeros(s, dtype=torch.float32, device=device)
            if k.startswith("rnn/") and cfg["model"]["rnn_type"] == "lstm":
                H = cfg["model"]["rnn_units"]
                v[H:2 * H] = 1.0
        else:
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
