"""Parallel layer: slab sharding over a `torch.distributed` process group.
Counterpart of `tritd_tpu/parallel/`."""

from .mesh import make_mesh, pad_to_multiple, shard_bounds
from .sharded_admm import SlabCollective, tritd_admm_batch_sharded, tritd_admm_sharded

__all__ = [
    "make_mesh",
    "pad_to_multiple",
    "shard_bounds",
    "SlabCollective",
    "tritd_admm_sharded",
    "tritd_admm_batch_sharded",
]
