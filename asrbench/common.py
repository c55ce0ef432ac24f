"""What every run shares: finding a cell's files and its model family by
name, the run's context, the device's identity, the result line and the
guard against JAX in the process."""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE_DIR = os.path.join(ROOT, "_asrbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "ctc_asr_tpu")
# a configuration file without a "family" key is of this one
DEFAULT_FAMILY = "conv_bilstm"
# what the harness calls of a family (asrbench/README.md); a decode cell's
# family has DECODE_HOOK besides
CONTRACT = ("TINY_CONFIG", "param_shapes", "init_fixed", "train_steps",
            "logits", "log_probs", "step_flops", "encoder_frames")
DECODE_HOOK = "shape_for_decode"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds, and two checkouts share nothing.
    The port's CUDA library builds into its own ``_build/<hash>``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ["USE_FLAX"] = "0"


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# the harness's own cut for its CPU tests (--tiny): the family's
# TINY_CONFIG, short utterances, the plain paths; never used on the chip
TINY_MIX = {"batch_size": 4, "num_buckets": 2, "pool_batches_per_bucket": 1,
            "filter_seconds": [0.7, 1.4], "vocabulary_words": 50}
# its limits: the cells' are set from readings at the cells' sizes
TINY_LIMITS = {"train": {"loss_gap": 0.01, "grad_gap": 0.05,
                         "change_gap": 0.1},
               "decode": {"frame_gap": 1.0, "dist_gap": 0.2,
                          "answer_gap": 0.01}}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


@dataclass
class Ctx:
    """One run: the cell's files, the command line and the clock."""

    cell: str
    workload: dict
    config_file: dict          # configs/<name>.json as a whole
    mix: dict                  # traffic/<name>.json
    cell_file: dict            # cells/<name>.json
    family: object             # reference/<family>.py, the model's module
    seed: int
    seconds: float
    trace: bool
    tiny: bool
    t_start: float
    metrics: list = field(default_factory=list)   # the cell's BENCHMARK.json
    # metric entries: end-to-end with --trace 0, per-layer with --trace 1

    @property
    def cfg(self) -> dict:
        """The configuration's sections, as the port's ``Config`` takes
        them."""
        return self.config_file["config"]

    @property
    def device(self) -> str:
        return "cpu" if self.tiny else "cuda"


def load_family(config_file: dict, path: str, driver: str):
    """The module ``asrbench/reference/<family>.py`` that the configuration
    file at ``path`` names under ``"family"`` (``conv_bilstm`` where it
    names none), checked against what ``driver`` calls; raises
    SystemExit, naming the file and the key, where there is no such
    module or it lacks a function of the contract."""
    name = config_file.get("family", DEFAULT_FAMILY)
    where = f'{path}: "family": {name!r}'
    if not (isinstance(name, str) and name.isidentifier()
            and importlib.util.find_spec(f"asrbench.reference.{name}")):
        raise SystemExit(f"asrbench: {where} names no module "
                         f"asrbench/reference/<family>.py")
    family = importlib.import_module(f"asrbench.reference.{name}")
    need = CONTRACT + ((DECODE_HOOK,) if driver == "decode" else ())
    missing = [k for k in need if not hasattr(family, k)]
    if missing:
        raise SystemExit(f"asrbench: {where}: asrbench/reference/{name}.py "
                         f"lacks {missing}, which a {driver} cell calls")
    return family


def load_ctx(cell: str, seed: int, seconds: float, trace: bool, tiny: bool,
             t_start: float, root: str = ROOT) -> Ctx:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has "
                         f"{sorted(work)}")
    w = work[cell]
    here = os.path.join(root, "asrbench")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config_file = _json(os.path.join(root, conf["file"]))
    from .traffic import load_mix
    mix = load_mix(w["traffic"], os.path.join(here, "traffic"))
    cell_file = _json(os.path.join(here, "cells", f"{cell}.json"))
    family = load_family(config_file, conf["file"], cell_file["driver"])
    if tiny:
        config_file = _merge(config_file, {"config": family.TINY_CONFIG})
        mix = _merge(mix, TINY_MIX)
        cell_file = dict(cell_file, limits=TINY_LIMITS[cell_file["driver"]])
    key = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[key]
               if cell in m.get("workloads", [cell])]
    return Ctx(cell, w, config_file, mix, cell_file, family, seed, seconds,
               trace, tiny, t_start, metrics)


def device_identity(n_chips: int) -> dict:
    """The card's name, count, power limit and clocks, and the versions,
    logged on earlier lines; raises SystemExit when the cell's chips are
    not there (nothing falls back to the CPU)."""
    import torch
    log(f"[asrbench] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("asrbench: no CUDA device (torch.cuda.is_available()"
                         " is false); the benchmark runs on the card only")
    count = torch.cuda.device_count()
    if count < n_chips:
        raise SystemExit(f"asrbench: the cell needs {n_chips} cards, "
                         f"{count} found")
    smi = {}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        fields = [f.strip() for f in out[0].split(",")]
        smi = dict(zip(("name", "power_limit", "clock_sm", "clock_sm_max",
                        "clock_mem", "temperature"), fields))
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        log(f"[asrbench] nvidia-smi gave nothing: {exc!r}")
    kind = torch.cuda.get_device_name(0)
    log(f"[asrbench] device {kind} x {count} (using {n_chips}); nvidia-smi: "
        + ", ".join(f"{k} {v}" for k, v in smi.items()))
    return {"platform": "gpu", "kind": kind, "count": n_chips, "smi": smi}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``ctc_asr_tpu_torch`` is not ``ctc_asr_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines on standard error, and the result as
    the last line on standard output with ``checks`` its last key."""
    checks = {k: {"value": c["value"] if math.isfinite(c["value"]) else None,
                  "limit": c["limit"]} for k, c in checks.items()}
    for name, c in checks.items():
        log(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})")
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
