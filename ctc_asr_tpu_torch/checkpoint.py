"""Checkpoints in the reference's flat-npz format: reading parameters for
serving, and writing and restoring the whole train state.

Counterpart of ``ctc_asr_tpu/checkpoint.py``. A checkpoint
``step_NNNNNNNN.npz`` maps "/"-joined pytree keypaths to arrays, with a
sidecar ``step_NNNNNNNN.json`` of metadata (loader cursor, best WER).
The train state is written under the keys the reference's
``init_train_state`` flattens to, so each package reads the other's:

- ``params/frontend/0/w``, ``params/rnn/0/fwd/wx``, ... (the port keeps
  the reference's parameter layouts, so a parameter crosses unchanged);
- the optax chain ``[clip_by_global_norm,] adam|adamw``:
  ``opt_state/<i>/0/.count``, ``opt_state/<i>/0/.mu/<param>``,
  ``opt_state/<i>/0/.nu/<param>`` and the schedule's
  ``opt_state/<i>/<1|2>/.count``, with i = 1 when clipping is on;
- ``step`` (int32) and ``rng`` (uint32[2]).

The port's own state, the torch generators of dropout and SpecAugment,
goes under ``torch_rng/...``, which the reference's loader ignores; the
model state that no optimizer updates (the Conformer's BatchNorm
running statistics, a model the reference does not have) under
``batch_stats/...``.
"""

from __future__ import annotations

import glob
import json
import os
import shutil

import numpy as np
import torch

from .config import Config, TrainConfig
from .models.encoder import init_shapes, state_shapes
from .parallel.mesh import process_world


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


def _ckpt_paths(ckpt_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(ckpt_dir, "step_*.npz")))


def latest_checkpoint(ckpt_dir: str) -> str | None:
    paths = _ckpt_paths(ckpt_dir)
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
    parameter tree (every key present, every shape equal). The model
    state (``batch_stats/...``) comes with the parameters, under its own
    keys: what an eval forward reads."""
    with np.load(resolve_checkpoint(path)) as z:
        params = params_from_jax({k: z[k] for k in z.files
                                  if k.startswith("params/")})
        params.update(model_state_from_flat(z, cfg))
    want = {**init_shapes(cfg.model, cfg.features.feature_dim),
            **state_shapes(cfg.model)}
    missing = sorted(set(want) - set(params))
    if missing:
        raise KeyError(f"checkpoint missing leaves {missing}")
    for k, shape in want.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"shape mismatch for {k!r}: ckpt "
                             f"{tuple(params[k].shape)} vs model {shape}")
    return {k: params[k].to(device) for k in want}


def _opt_keys(tcfg: TrainConfig) -> tuple[str, str]:
    """(Adam state prefix, schedule count key) of the optax chain."""
    base = f"opt_state/{1 if tcfg.grad_clip_norm > 0 else 0}"
    sched = 2 if tcfg.weight_decay > 0 else 1
    return f"{base}/0/", f"{base}/{sched}/.count"


def state_to_flat(params: dict, opt_state: dict, step: int,
                  rng_states: dict[str, torch.Tensor],
                  tcfg: TrainConfig, seed: int,
                  model_state: dict | None = None) -> dict[str, np.ndarray]:
    """The train state as the reference's flat keypath -> array dict.
    ``rng`` (the reference's PRNG key) is written as [seed, step]: torch
    cannot produce JAX's key, and any uint32[2] is a valid one."""
    adam, sched = _opt_keys(tcfg)
    flat = {}
    for k, v in params.items():
        flat[f"params/{k}"] = v.detach().float().cpu().numpy()
    flat[adam + ".count"] = np.asarray(opt_state["count"], np.int32)
    for part in ("mu", "nu"):
        for k, v in opt_state[part].items():
            flat[f"{adam}.{part}/{k}"] = v.float().cpu().numpy()
    flat[sched] = np.asarray(opt_state["count"], np.int32)
    flat["step"] = np.asarray(step, np.int32)
    flat["rng"] = np.asarray([seed, step], np.uint32)
    for name, st in rng_states.items():
        flat[f"torch_rng/{name}"] = st.cpu().numpy()
    for k, v in (model_state or {}).items():
        flat[f"batch_stats/{k}"] = v.float().cpu().numpy()
    return flat


def model_state_from_flat(flat, cfg: Config) -> dict[str, torch.Tensor]:
    """The model state (``batch_stats/...``) of a flat checkpoint dict
    on the CPU, checked against the configured model's; empty for a
    model that keeps none."""
    out = {}
    for k, shape in state_shapes(cfg.model).items():
        key = f"batch_stats/{k}"
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        v = np.asarray(flat[key], np.float32)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key!r}: ckpt "
                             f"{tuple(v.shape)} vs model {tuple(shape)}")
        out[k] = torch.from_numpy(np.array(v))
    return out


def state_from_flat(flat: dict[str, np.ndarray], cfg: Config):
    """(params, opt_state, step, rng_states) on the CPU from a flat
    checkpoint dict, checked against the configured model's tree. Either
    package's checkpoint loads; one without ``torch_rng/...`` keys (the
    reference's) gives empty ``rng_states``."""
    want = init_shapes(cfg.model, cfg.features.feature_dim)
    adam, sched = _opt_keys(cfg.train)

    def get(key, shape=None):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        v = np.asarray(flat[key])
        if shape is not None and tuple(v.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key!r}: ckpt "
                             f"{tuple(v.shape)} vs model {tuple(shape)}")
        return v

    params = {k: torch.from_numpy(np.array(get(f"params/{k}", s),
                                           np.float32))
              for k, s in want.items()}
    opt_state = {"count": int(get(adam + ".count"))}
    for part in ("mu", "nu"):
        opt_state[part] = {
            k: torch.from_numpy(np.array(get(f"{adam}.{part}/{k}", s),
                                         np.float32))
            for k, s in want.items()}
    if int(get(sched)) != opt_state["count"]:
        raise ValueError("checkpoint's Adam and schedule counts differ")
    rng_states = {k[len("torch_rng/"):]: torch.from_numpy(np.array(v))
                  for k, v in flat.items() if k.startswith("torch_rng/")}
    return params, opt_state, int(get("step")), rng_states


def save_checkpoint(ckpt_dir: str, step: int, flat: dict[str, np.ndarray],
                    metadata: dict | None = None, keep: int = 5,
                    is_best: bool = False,
                    process_index: int | None = None) -> str | None:
    """Write ``step_NNNNNNNN.npz`` (atomically, through a temporary file)
    and its ``.json`` sidecar; with ``is_best`` also the ``best`` alias.
    Keeps the newest ``keep`` step checkpoints (``checkpoint.py:56-94``).
    Only process 0 writes (``process_index``, by default this process's
    rank in the formed ``torch.distributed`` group); the others return
    None."""
    if process_index is None:
        process_index = process_world()[1]
    if process_index != 0:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = base + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, base + ".npz")
    meta = dict(metadata or {})
    meta["step"] = int(step)
    with open(base + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=float)
    if is_best:
        for ext in (".npz", ".json"):
            best = os.path.join(ckpt_dir, "best" + ext)
            if os.path.lexists(best):
                os.remove(best)
            try:
                os.link(base + ext, best)
            except OSError:
                shutil.copyfile(base + ext, best)
    if keep > 0:
        for old in _ckpt_paths(ckpt_dir)[:-keep]:
            for path in (old, old[:-len(".npz")] + ".json"):
                if os.path.exists(path):
                    os.remove(path)
    return base + ".npz"


def restore_latest(ckpt_dir: str) -> tuple[dict | None, dict]:
    """(flat dict, metadata) of the newest checkpoint, or (None, {})."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None, {}
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta_path = path[:-len(".npz")] + ".json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return flat, meta
