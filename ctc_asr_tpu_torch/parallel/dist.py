"""Process-group init, the groups of the process grid, and the collectives
of the data- and tensor-parallel regimes.

Counterpart of ``ctc_asr_tpu/parallel/dist.py``. The reference runs its
train step under ``shard_map`` over a device mesh (data parallelism) or
under GSPMD with the wide leaves sharded over 'model' (tensor
parallelism, ``make_sharded_train_step``). The port runs one process a
device in a ``torch.distributed`` group (NCCL on CUDA, gloo on the CPU),
and the pieces here make the processes one run:

- ``initialize_distributed`` forms the group (``dist.py:24-46``);
- ``grid_groups`` forms the model group (one data row) and the data
  group (one model column) of this rank;
- ``all_reduce_mean`` is the ``pmean``: one ``all_reduce(SUM)`` over one
  flat f32 buffer, divided by the group's size;
- ``gather_columns`` concatenates the ranks' column shards of a tensor
  in rank order, with the collective the group's backend takes;
- ``broadcast_state`` starts the replicas equal, ``shard_state`` keeps a
  rank's columns of the wide leaves and ``gather_state`` puts them back
  together (``shard_tree`` / ``replicate_tree``, ``dist.py:65-85``);
- ``reseed_for_row`` is the counterpart of ``fold_in(dropout_rng,
  axis_index('data'))`` (``ctc_asr_tpu/train.py:116-118``);
- ``gather_records`` gathers evaluation's per-utterance records in the
  reference's process-major order (``ctc_asr_tpu/evaluate.py:206-228``).

The tensor-parallel step itself, with its autograd collectives, is
``parallel.tp``.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..ops.dispatch import resolve_device
from .mesh import ProcessMesh

# a rank that fails leaves the others in a collective: they raise after
# this long instead of waiting for ever (first calls build and load the
# kernels, and rank 0 alone writes checkpoints, so it is generous)
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(cfg: MeshConfig, device="cuda") -> bool:
    """Form the process group of a multi-process run; True if it did.

    A no-op (False) unless ``coordinator_address`` is set and
    ``num_processes > 1``. The backend follows the device: NCCL for CUDA,
    on card ``process_id % device_count`` (set before the group forms),
    and gloo for the CPU, as the reference takes gloo for its CPU
    collectives. Raises when the group's size is not ``num_processes``."""
    if not (cfg.coordinator_address and cfg.num_processes > 1):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(cfg.process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=cfg.process_id, timeout=TIMEOUT)
    if dist.get_world_size() != cfg.num_processes:
        raise RuntimeError(
            f"torch.distributed came up with {dist.get_world_size()} "
            f"processes, expected {cfg.num_processes}")
    return True


def current_group():
    """The formed group (``WORLD``), or None in a single-process run."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


@dataclass(frozen=True)
class GridGroups:
    """This rank's groups: ``world``, ``model`` (the ranks of its data
    row, which hold the column shards of one parameter set) and ``data``
    (the ranks of its model column, which hold the same shard)."""

    world: object
    model: object
    data: object


def grid_groups(mesh: ProcessMesh) -> GridGroups:
    """Form the model and data groups of ``mesh``. ``new_group`` is a
    collective of the whole world: every rank creates every group, in the
    same order (the data rows, then the model columns), and keeps its
    own."""
    model = data = None
    for r in range(mesh.data):
        g = dist.new_group([r * mesh.model + c for c in range(mesh.model)])
        if r == mesh.data_row:
            model = g
    for c in range(mesh.model):
        g = dist.new_group([r * mesh.model + c for r in range(mesh.data)])
        if c == mesh.model_col:
            data = g
    return GridGroups(world=dist.group.WORLD, model=model, data=data)


def all_reduce_mean(tensors: list[torch.Tensor],
                    group) -> list[torch.Tensor]:
    """The mean over the group's ranks of each tensor (the reference's
    ``pmean``): ONE ``all_reduce(SUM)`` over one flat f32 buffer holding
    them all, divided by the group's size. Returns f32 views of it."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    return [v.view(t.shape) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """[..., c] on each of the group's n ranks -> [..., n * c], the
    ranks' columns in rank order (the same tensor on every rank).

    The collective follows the group's backend, never a caught error:
    NCCL gathers into one tensor (``all_gather_into_tensor``); gloo
    gathers CPU tensors (``all_gather``), and for CUDA tensors, which its
    ``all_gather`` does not take, sums a zero buffer into which each rank
    wrote its own slot (``all_reduce``; adding zeros is exact)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((n, *x.shape))
        dist.all_gather_into_tensor(out, x, group=group)
    elif x.is_cuda:
        out = x.new_zeros((n, *x.shape))
        out[dist.get_rank(group)] = x
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.stack(parts)
    return out.movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])


def _state_leaves(state: dict) -> list[torch.Tensor]:
    return [*state["params"].values(), *state["opt_state"]["mu"].values(),
            *state["opt_state"]["nu"].values()]


def broadcast_state(state: dict, group, src: int = 0) -> None:
    """Overwrite every rank's parameters and Adam moments with rank
    ``src``'s, in one broadcast of one flat buffer. The step and the Adam
    count are host ints that every rank restored alike."""
    leaves = _state_leaves(state)
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    dist.broadcast(flat, src, group=group)
    with torch.no_grad():
        for t, v in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(v.view(t.shape))


def _columns(t: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    width = t.shape[-1]
    if width % mesh.model:
        raise ValueError(f"a leaf of width {width} does not split over a "
                         f"model axis of {mesh.model}")
    c = width // mesh.model
    return t[..., mesh.model_col * c:(mesh.model_col + 1) * c]


def shard_state(state: dict, mesh: ProcessMesh, sharded: frozenset) -> None:
    """Keep this rank's columns of each ``sharded`` parameter and of its
    Adam moments, in place of the full leaves every rank holds (the
    port's ``shard_tree`` with ``state_shardings``: rank ``model_col``
    owns the ``model_col``-th block of the last dim)."""
    params = state["params"]
    for k in sharded:
        params[k] = _columns(params[k].detach(), mesh).clone() \
            .requires_grad_(True)
        for part in ("mu", "nu"):
            m = state["opt_state"][part]
            m[k] = _columns(m[k], mesh).clone()


def gather_state(state: dict, sharded: frozenset, group) -> dict:
    """A state whose ``sharded`` parameters and moments are the full
    leaves again, gathered over this rank's model ``group`` (a
    collective: every rank of the group calls it); the other leaves,
    the step, the count and the generators are the state's own."""
    params = {k: (gather_columns(v.detach(), group) if k in sharded
                  else v.detach()) for k, v in state["params"].items()}
    opt = {"count": state["opt_state"]["count"]}
    for part in ("mu", "nu"):
        opt[part] = {k: (gather_columns(v, group) if k in sharded else v)
                     for k, v in state["opt_state"][part].items()}
    return {**state, "params": params, "opt_state": opt}


def reseed_for_row(generators: dict, seed: int, step: int,
                   row: int) -> None:
    """Seed each generator from (seed, step, data row, its index): the
    data rows draw different dropout and SpecAugment masks, the ranks of
    one model group (one row) the same ones, and a run resumed at any
    step draws what the uninterrupted run drew, from numbers the host
    knows (no generator state crosses processes or checkpoints). Under
    pure data parallelism the row is the rank."""
    for i, gen in enumerate(generators.values()):
        s = np.random.SeedSequence([seed, step, row, i]).generate_state(
            1, np.uint64)[0]
        gen.manual_seed(int(s))


def gather_records(records: list, group) -> list:
    """Every rank's per-utterance records, rank 0's first, then rank 1's,
    ... (the reference's process-major order, ROADMAP.md C2). The shards
    may be of unequal size (``drop_last=False``): ``all_gather_object``
    pads each rank's pickled list to the largest and masks the padding
    itself, and it gathers through host objects, which gloo and NCCL both
    take."""
    parts: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, [tuple(r) for r in records], group=group)
    return [r for part in parts for r in part]
