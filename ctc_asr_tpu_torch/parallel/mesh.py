"""The process grid of the data-parallel regime.

Counterpart of ``ctc_asr_tpu/parallel/mesh.py:20-33`` (``build_mesh``)
and of the pure-DP branch of ``ctc_asr_tpu/train.py:258-282``
(``_loader_sharding_for_mesh``). The reference lays a ('data', 'model')
mesh over devices; the port runs one process a device, so its mesh is
a grid of the processes of the ``torch.distributed`` group (one process
without a group). Only the data axis is ported: a model axis,
``shard_model`` and a sequence axis raise before any work, and the
sharding rules ``param_shardings`` / ``state_shardings``
(``mesh.py:45-88``) wait with them for ROADMAP.md A8.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from ..config import MeshConfig


@dataclass(frozen=True)
class ProcessMesh:
    """``data`` processes on the data axis (the only axis ported);
    ``rank`` is this process's."""

    data: int
    rank: int


def process_world() -> tuple[int, int]:
    """(world size, rank) of the formed ``torch.distributed`` group, or
    (1, 0) when none is formed."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def check_ported(cfg: MeshConfig) -> None:
    """Raise for the regimes the port does not have yet: tensor
    parallelism (a model axis, ``shard_model``) and sequence
    parallelism."""
    if cfg.model_axis > 1 or cfg.shard_model or cfg.seq_axis > 1:
        raise NotImplementedError(
            f"mesh.model_axis={cfg.model_axis}, mesh.shard_model="
            f"{cfg.shard_model}, mesh.seq_axis={cfg.seq_axis}: the port "
            "has the data axis only; tensor and sequence parallelism are "
            "not ported yet (ROADMAP.md A8)")


def build_mesh(cfg: MeshConfig, world_size: int | None = None,
               rank: int | None = None) -> ProcessMesh:
    """The process grid of ``world_size`` processes (default: the formed
    group's) by the reference's rules: ``data_axis == -1`` means all the
    processes the model axis leaves. Raises when ``num_processes > 1``
    names a group that is not the one formed, and for an unported
    regime (``check_ported``)."""
    if world_size is None:
        world_size, rank = process_world()
    rank = 0 if rank is None else rank
    if cfg.num_processes > 1 and world_size != cfg.num_processes:
        raise RuntimeError(
            f"mesh.num_processes={cfg.num_processes}, but the formed "
            f"process group has {world_size} (none is formed when 1): "
            "call parallel.initialize_distributed first, as cli train and "
            "cli evaluate do given --mesh.coordinator_address")
    n = world_size
    model = max(1, cfg.model_axis)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model axis {model}")
    data = cfg.data_axis if cfg.data_axis > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    check_ported(cfg)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a group of {n}")
    return ProcessMesh(data=data, rank=rank)


def loader_shard(mesh: ProcessMesh) -> tuple[int, int]:
    """(shard_idx, num_shards) of this process's loader: under pure data
    parallelism, (rank, world size)."""
    return mesh.rank, mesh.data
