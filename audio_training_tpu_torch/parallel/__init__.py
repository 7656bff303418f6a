"""Data parallel over ``torch.distributed`` (port of
``audio_training_tpu/parallel``): JAX's seven names, the collectives that
keep the global-batch reductions global, and the collective audit."""

from audio_training_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from audio_training_tpu_torch.parallel.multihost import (
    global_batch_from_local,
    initialize_distributed,
    process_shard,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "initialize_distributed",
    "process_shard",
    "global_batch_from_local",
]
