"""Parallel layer: slab sharding over a `torch.distributed` process group.
Counterpart of `tritd_tpu/parallel/`; the reference's `slab_sharding` and
`replicated` are JAX `NamedSharding` objects, which a rank holding its own
slab (`shard_bounds`) does not need."""

from .distributed import initialize_distributed, make_global_slab_mesh, make_host_chip_mesh
from .mesh import make_mesh, pad_to_multiple, shard_bounds
from .sharded_admm import SlabCollective, tritd_admm_auto, tritd_admm_batch_sharded, tritd_admm_sharded

__all__ = [
    "make_mesh",
    "pad_to_multiple",
    "shard_bounds",
    "SlabCollective",
    "tritd_admm_sharded",
    "tritd_admm_auto",
    "tritd_admm_batch_sharded",
    "initialize_distributed",
    "make_host_chip_mesh",
    "make_global_slab_mesh",
]
