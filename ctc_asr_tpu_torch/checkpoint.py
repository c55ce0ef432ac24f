"""Checkpoint reading: the reference's flat-npz snapshots -> torch params.

Counterpart of the read side of ``ctc_asr_tpu/checkpoint.py``. A
checkpoint ``step_NNNNNNNN.npz`` maps "/"-joined pytree keypaths to
arrays: ``params/frontend/0/w``, ``params/rnn/0/fwd/wx``,
``params/head/b``, plus ``opt_state/...``, ``step`` and ``rng``, which
inference ignores. The port keeps the reference's parameter layouts,
so a parameter crosses unchanged.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ctc_asr_tpu.config import Config

from .models.encoder import init_shapes


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat JAX keypaths -> the port's flat float32 parameter dict.

    Takes a checkpoint's flat dict (keys under ``params/``; the rest is
    dropped) or a flattened bare params tree (no prefix). Returns CPU
    tensors keyed by the keypath below ``params/``."""
    if any(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()
                if k.startswith("params/")}
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def latest_checkpoint(ckpt_dir: str) -> str | None:
    paths = sorted(glob.glob(os.path.join(ckpt_dir, "step_*.npz")))
    return paths[-1] if paths else None


def resolve_checkpoint(path: str) -> str:
    """A ``.npz`` path as given; a train dir -> its newest
    ``ckpt/step_*.npz`` (as the reference CLI resolves ``--ckpt``)."""
    if path.endswith(".npz"):
        return path
    return latest_checkpoint(os.path.join(path, "ckpt")) or path


def load_params(path: str, cfg: Config,
                device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Read a checkpoint and check it against the configured model's
    parameter tree (every key present, every shape equal)."""
    with np.load(resolve_checkpoint(path)) as z:
        params = params_from_jax({k: z[k] for k in z.files
                                  if k.startswith("params/")})
    want = init_shapes(cfg.model, cfg.features.feature_dim)
    missing = sorted(set(want) - set(params))
    if missing:
        raise KeyError(f"checkpoint missing leaves {missing}")
    for k, shape in want.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"shape mismatch for {k!r}: ckpt "
                             f"{tuple(params[k].shape)} vs model {shape}")
    return {k: params[k].to(device) for k in want}
