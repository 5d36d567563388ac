"""Process-mesh helpers for multi-device TriTD.

PyTorch counterpart of `tritd_tpu/parallel/mesh.py`. The reference is one
program over a `jax.sharding.Mesh` of devices; here every device has its own
process, the processes form a `torch.distributed` process group, and the
mesh is a `DeviceMesh` over the group's ranks with the reference's axis
names: independent problems along "data", slabs of one problem along "slab".
A collective over the "slab" axis is `dist.all_reduce(x, group=slab_group)`.

`slab_sharding` and `replicated` of the reference are JAX sharding objects
(`NamedSharding`) and have no meaning in PyTorch, where a rank simply holds
its slab: they are left out. `shard_bounds` says which slab that is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "slab")


def make_mesh(n_slab: int | None = None, n_data: int = 1, devices=None, *, device_type: str = "cuda"):
    """2-D `DeviceMesh` ("data", "slab") over the ranks of the default
    process group, which must be initialized. `n_slab` defaults to the world
    size over `n_data`; the mesh must cover every rank (each rank is a
    process and cannot sit out of a collective program). `devices`, as the
    reference takes them: the devices of the ranks (`torch.device`s or
    names, one a rank, of one type), whose type is `device_type` and whose
    count is the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if devices is not None:
        kinds = {torch.device(d).type for d in devices}
        if len(kinds) != 1 or len(devices) != world:
            raise ValueError(f"devices: one device of one type a rank, {world} in all; got {list(devices)}")
        device_type = kinds.pop()
    if n_slab is None:
        n_slab = world // n_data
    if n_data * n_slab != world:
        raise ValueError(f"mesh {n_data} x {n_slab} does not cover the {world} ranks of the process group")
    return init_device_mesh(device_type, (n_data, n_slab), mesh_dim_names=AXES)


def pad_to_multiple(x, axis: int, multiple: int):
    """Zero-pad one axis up to a multiple; returns the padded array and the
    original size. Zero rows are inert in every TriTD contraction (they add
    nothing to Grams or right-hand sides), so nothing downstream masks them."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    return _pad_with(x, axis, target, 0), size


def _pad_with(x, axis: int, target: int, value):
    """Pad one axis of a tensor or numpy array up to `target` with a constant."""
    size = x.shape[axis]
    if size == target:
        return x
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = target - size
        return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=axis)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return np.pad(x, pad, constant_values=value)


def shard_bounds(padded_size: int, n_shards: int, index: int) -> tuple[int, int]:
    """[start, stop) of shard `index` along an axis of `padded_size`, which
    must be a multiple of `n_shards` (see :func:`pad_to_multiple`)."""
    if padded_size % n_shards:
        raise ValueError(f"axis of {padded_size} is not a multiple of {n_shards} shards")
    if not 0 <= index < n_shards:
        raise ValueError(f"shard index {index} outside 0..{n_shards - 1}")
    width = padded_size // n_shards
    return index * width, (index + 1) * width
