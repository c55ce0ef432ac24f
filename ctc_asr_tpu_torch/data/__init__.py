"""Data layer: manifests, bucketed sharded loading, corpus generation.

The port's own copy of ``ctc_asr_tpu/data``: CSV manifests and a
deterministic, ``(shard_idx, num_shards)``-parameterized loader
producing fixed-shape padded numpy batches, the synthetic corpus, the
native wav decoder's binding and the read side of the feature cache.
"""

from .manifest import Manifest, Utterance, read_manifest, write_manifest
from .loader import BatchSpec, Batch, DataLoader

__all__ = ["Manifest", "Utterance", "read_manifest", "write_manifest",
           "BatchSpec", "Batch", "DataLoader"]
