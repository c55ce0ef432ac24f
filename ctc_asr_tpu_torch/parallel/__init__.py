"""Parallel regimes of the port: data, tensor and sequence parallelism.

Counterpart of ``ctc_asr_tpu/parallel/__init__.py``. The reference's
primary strategy is data parallelism (its docstring, ``:7-9``); the port
runs it in PyTorch's idiom, one process a device in a
``torch.distributed`` group (NCCL on CUDA, gloo on the CPU), with the
gradients averaged by one ``all_reduce``. ``mesh`` holds the process
grid, the loader's shard and the sharding rule, ``dist`` the group, its
model and data groups and the collectives, ``tp`` the column-parallel
encoder over the model axis, ``decode_dist`` the row-sharded char-LM
lookup, and ``seqpar`` sequence parallelism in one process over several
devices.
"""

from .dist import initialize_distributed
from .mesh import build_mesh, loader_shard

__all__ = ["initialize_distributed", "build_mesh", "loader_shard"]
