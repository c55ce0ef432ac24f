"""Process-group init and the collectives of the data-parallel regime.

Counterpart of the data axis of ``ctc_asr_tpu/parallel/dist.py``. The
reference runs its train step under ``shard_map`` over a device mesh,
each device on its local batch shard with every Pallas kernel, and
``pmean``s the gradients and the loss over 'data'. The port runs one
process a device in a ``torch.distributed`` group (NCCL on CUDA, gloo
on the CPU): each process runs the single-device step, with every CUDA
kernel, on its loader shard, and the pieces here make the processes one
run:

- ``initialize_distributed`` forms the group (``dist.py:24-46``);
- ``all_reduce_mean`` is the ``pmean``: one ``all_reduce(SUM)`` over one
  flat f32 buffer, divided by the world size;
- ``broadcast_state`` starts the replicas equal (``shard_tree`` /
  ``replicate_tree``, ``dist.py:65-85``);
- ``reseed_for_rank`` is the counterpart of ``fold_in(dropout_rng,
  axis_index)`` (``ctc_asr_tpu/train.py:116-118``);
- ``gather_records`` gathers evaluation's per-utterance records in the
  reference's process-major order (``ctc_asr_tpu/evaluate.py:206-228``).

The eval step and the decoders need nothing here: each process runs
``evaluate``'s own on its shard (``make_sharded_eval_step`` /
``make_distributed_beam_decoder`` on the data axis). The tensor-parallel
branch (``_hybrid_cfg``, ``_batch_islands``, ``dist.py:99-140``) waits
for ROADMAP.md A8.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..ops.dispatch import resolve_device

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


def all_reduce_mean(tensors: list[torch.Tensor],
                    group) -> list[torch.Tensor]:
    """The mean over the group's ranks of each tensor (the reference's
    ``pmean``): ONE ``all_reduce(SUM)`` over one flat f32 buffer holding
    them all, divided by the world size. Returns f32 views of it."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    return [v.view(t.shape) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast_state(state: dict, group, src: int = 0) -> None:
    """Overwrite every rank's parameters and Adam moments with rank
    ``src``'s, in one broadcast of one flat buffer. The step and the Adam
    count are host ints that every rank restored alike."""
    leaves = [*state["params"].values(), *state["opt_state"]["mu"].values(),
              *state["opt_state"]["nu"].values()]
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    dist.broadcast(flat, src, group=group)
    with torch.no_grad():
        for t, v in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(v.view(t.shape))


def reseed_for_rank(generators: dict, seed: int, step: int,
                    rank: int) -> None:
    """Seed each generator from (seed, step, rank, its index): the ranks
    draw different dropout and SpecAugment masks, and a run resumed at
    any step draws what the uninterrupted run drew, from numbers the host
    knows (no generator state crosses processes or checkpoints)."""
    for i, gen in enumerate(generators.values()):
        s = np.random.SeedSequence([seed, step, rank, i]).generate_state(
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
