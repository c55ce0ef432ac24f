"""The process grid and the sharding rule of the parallel regimes.

Counterpart of ``ctc_asr_tpu/parallel/mesh.py`` (``build_mesh``,
``_param_spec``) and of ``ctc_asr_tpu/train.py:258-282``
(``_loader_sharding_for_mesh``). The reference lays a ('data', 'model')
mesh over devices; the port runs one process a device, so its mesh is a
grid of the processes of the ``torch.distributed`` group (one process
without a group), laid out as the reference's ``devices.reshape(data,
model)``: ``rank = data_row * model + model_col``. A model group is one
data row (the ranks that hold the column shards of one parameter set and
read the same batches); a data group is one model column (the ranks that
hold the same shard). The sequence axis is not a process axis: the
reference runs it in one process over local devices, and so does the
port (``parallel.seqpar``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

from ..config import MeshConfig

# the reference's width rule (``mesh.py:58-59``): a leaf whose last dim is
# at least this wide shards that dim over 'model'
SHARD_MIN_WIDTH = 256


@dataclass(frozen=True)
class ProcessMesh:
    """``data`` x ``model`` processes; ``rank`` is this process's, and
    ``shard_model`` whether the wide leaves shard over 'model'."""

    data: int
    rank: int
    model: int = 1
    shard_model: bool = False

    @property
    def data_row(self) -> int:
        return self.rank // self.model

    @property
    def model_col(self) -> int:
        return self.rank % self.model

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def tensor_parallel(self) -> bool:
        """True when leaves really shard: ``shard_model`` on a model axis
        of more than one process (on an axis of one, the reference's
        'model' sharding is a no-op)."""
        return self.shard_model and self.model > 1


def process_world() -> tuple[int, int]:
    """(world size, rank) of the formed ``torch.distributed`` group, or
    (1, 0) when none is formed."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def check_ported(cfg: MeshConfig, world_size: int) -> None:
    """Raise for what the reference itself refuses before any work:
    sequence parallelism together with more than one process
    (``ctc_asr_tpu/train.py:305-315``)."""
    if cfg.seq_axis > 1 and max(world_size, cfg.num_processes) > 1:
        raise ValueError(
            f"mesh.seq_axis={cfg.seq_axis} is not supported with "
            f"multi-process training (process_count="
            f"{max(world_size, cfg.num_processes)}); run SP single-process "
            "over local devices, or unset mesh.seq_axis for the "
            "multi-process DP/DPxTP regimes")


def build_mesh(cfg: MeshConfig, world_size: int | None = None,
               rank: int | None = None) -> ProcessMesh:
    """The process grid of ``world_size`` processes (default: the formed
    group's) by the reference's rules: ``data_axis == -1`` means all the
    processes the model axis leaves. Raises for sequence parallelism with
    more than one process (``check_ported``), when ``num_processes > 1``
    names a group that is not the one formed, and for sizes that do not
    tile the group."""
    if world_size is None:
        world_size, rank = process_world()
    rank = 0 if rank is None else rank
    check_ported(cfg, world_size)
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
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a group of {n}")
    return ProcessMesh(data=data, rank=rank, model=model,
                       shard_model=cfg.shard_model)


def loader_shard(mesh: ProcessMesh) -> tuple[int, int]:
    """(shard_idx, num_shards) of this process's training loader: the
    batch shards over 'data' only, so under a model axis the ranks of one
    data row read the same shard, ``(data_row, data)``; under pure data
    parallelism that is ``(rank, world size)``."""
    return mesh.data_row, mesh.data


def param_spec(key: str, shape: tuple, shard_model: bool) -> int | None:
    """The dim of a leaf that shards over 'model', or None
    (``_param_spec``): the last dim when ``shard_model``, the leaf is at
    least ``SHARD_MIN_WIDTH`` wide there, and it is not the head's. For
    ``conv_bilstm3`` that is every ``rnn/*/wx``, ``wh`` and ``b`` (2048
    gate columns), and a dense frontend's ``w`` and ``b`` of width >= 256;
    the 32-channel conv kernels and the head stay whole. Adam's moments
    take their parameter's rule (``state_shardings``)."""
    if not shard_model or "head" in key.split("/"):
        return None
    if len(shape) < 1 or shape[-1] < SHARD_MIN_WIDTH:
        return None
    return len(shape) - 1
