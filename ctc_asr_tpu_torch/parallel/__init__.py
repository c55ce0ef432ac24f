"""Parallel regimes of the port: data parallelism across processes.

Counterpart of ``ctc_asr_tpu/parallel/__init__.py``. The reference's
primary strategy is data parallelism (its docstring, ``:7-9``); the port
runs it in PyTorch's idiom, one process a device in a
``torch.distributed`` group (NCCL on CUDA, gloo on the CPU), with the
gradients averaged by one ``all_reduce``. ``mesh`` holds the process
grid and the loader's shard, ``dist`` the group and the collectives.
Tensor parallelism, sequence parallelism and the row-sharded LM lookup
(``seqpar.py``, ``decode_dist.py``) wait for ROADMAP.md A8.
"""

from .dist import initialize_distributed
from .mesh import build_mesh, loader_shard

__all__ = ["initialize_distributed", "build_mesh", "loader_shard"]
