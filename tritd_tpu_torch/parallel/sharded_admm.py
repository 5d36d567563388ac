"""Multi-device TriTD-ADMM: mode-1 slab / mode-3 frame sharding over a
`torch.distributed` process group.

PyTorch counterpart of `tritd_tpu/parallel/sharded_admm.py`. The reference
is one program (`shard_map` over a `Mesh`, `jax.lax.psum` inside a
`while_loop`); here every shard is a process of an SPMD program, holds its
slab on its own device, and completes sums with `dist.all_reduce` in the
host loop of :func:`tritd_tpu_torch.solvers.admm.run_admm`. The iteration is
the single-device one, told where sums are completed (:class:`SlabCollective`);
it is not written out a second time.

The data-sized tensors (D, O, E, Y_L, Y_O, T and the mode-1 core A) are
sharded along mode-1 slabs; B, C and every (r^2, r^2) Gram are replicated.
Per iteration the only traffic between shards is

  * the sum of GramA                 r^4 words
  * the sum of the mode-2 RHS        n2 r^2 words
  * the sum of the mode-3 RHS        n3 r^2 words
  * one vector of the two residual sums of squares (and the RRE numerator
    when `origin` is given)

The O(n^3 r^2) GEMMs, the reconstruction and the fused elementwise block are
local to the shard. On a CUDA device the block is the hand-written kernel
(`ops/hopper_kernels.py`), launched once per iteration on the shard's slab.
`shard_tensor_mode=3` is the sequence-parallel layout for long videos: D and
the C core are sharded along mode-3 frames; GramC and the mode-1/2 RHS are
reduced instead. Masked completion imputes with a local `triple_product` and
adds no collective.

Zero-padding n1 (or n3) to a multiple of the shard count is inert: padded
entries of D are zero and the padded factor rows (frames) start at zero, so
their RHS rows, factor rows and Gram contributions stay zero. Masks are
padded with True (an observed zero), origins with zeros.

The replicated solves stay replicated without a broadcast: their inputs are
reduced sums, equal bit for bit on every shard, and every shard makes the
same library call on them. The stop flag comes from reduced sums only, so
every shard leaves the loop in the same iteration.

Every rank calls these functions with the same full tensor (numpy or a CPU
tensor), keeps its own slab and moves only that to its device. The result is
assembled to full size on every rank after the loop.

Not ported: `tritd_admm_auto`, which hands the single-device program to
XLA's SPMD partitioner; PyTorch has no counterpart that covers this solver's
operations.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .. import interop
from ..ops.narrow import narrow_cast
from ..solvers.admm import init_factors, init_state, run_admm
from ..solvers.base import TriTDConfig, TriTDResult
from ..utils.timing import sync
from .mesh import _pad_with, shard_bounds

AXIS = "slab"
DATA_AXIS = "data"


class SlabCollective:
    """Where the sums of a sharded iteration are completed: `all_reduce` over
    the process group `group`, for the layout `shard_mode` (1 or 3). Counts
    its calls and the words and bytes they carried."""

    def __init__(self, group, shard_mode: int):
        if shard_mode not in (1, 3):
            raise ValueError(f"shard_tensor_mode must be 1 or 3, got {shard_mode}")
        self.group = group
        self.shard_mode = shard_mode
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.calls = self.words = self.bytes = 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the shards, on its device; returns the sum."""
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        self.calls += 1
        self.words += x.numel()
        self.bytes += x.numel() * x.element_size()
        return x

    def counts(self) -> dict:
        return {"calls": self.calls, "words": self.words, "bytes": self.bytes}


def _slab_group(mesh_or_group):
    """The process group of the "slab" axis of a DeviceMesh, or the group."""
    if isinstance(mesh_or_group, dist.ProcessGroup):
        return mesh_or_group
    return mesh_or_group.get_group(AXIS)


def _shard_device(mesh_or_group, d, device) -> torch.device:
    """The device this rank keeps its slab on: `device` when given, else the
    current device of the mesh's device type, else (a bare group) d's."""
    if device is not None:
        return torch.device(device)
    if not isinstance(mesh_or_group, dist.ProcessGroup):
        kind = mesh_or_group.device_type
        return torch.device(kind, torch.cuda.current_device()) if kind == "cuda" else torch.device(kind)
    return d.device if isinstance(d, torch.Tensor) else torch.device("cpu")


def _check_mask(cfg: TriTDConfig, mask, name: str = "mask") -> None:
    if cfg.masked and mask is None:
        raise ValueError(f"cfg.masked=True requires a {name} argument")
    if mask is not None and not cfg.masked:
        raise ValueError(f"{name} given but cfg.masked=False — pass TriTDConfig(masked=True)")


def _local_solve(d, cfg: TriTDConfig, coll: SlabCollective, mask, origin, init, device):
    """Solve on this rank's shard. Returns the final state (its sharded
    tensors local), (lo, hi, padded size, original size) of the shard along
    the sharded axis, and the audit: the collective's counts in the set-up
    (the norms' one vector) and in one iteration (every iteration makes the
    same calls), the iterations done and the loop's seconds on the host
    clock, the device synchronized before and after."""
    dtype = cfg.torch_dtype()
    axis = 0 if coll.shard_mode == 1 else 2
    before = coll.counts()
    n_orig = d.shape[axis]
    target = -(-n_orig // coll.size) * coll.size
    lo, hi = shard_bounds(target, coll.size, coll.index)

    def local(x, fill, dt):
        # cut the slab from what exists of it, move that alone, pad the rest
        x = torch.as_tensor(x).narrow(axis, min(lo, n_orig), max(min(hi, n_orig) - lo, 0))
        return _pad_with(narrow_cast(x.to(device), dt), axis, hi - lo, fill).contiguous()

    d_loc = local(d, 0, dtype)
    mask_loc = None if mask is None else local(mask, True, torch.bool)
    origin_loc = None if origin is None else local(origin, 0, dtype)

    # the norms of the whole tensor, reduced once, as sums of squares
    sums = [torch.sum(d_loc * d_loc)]
    if origin_loc is not None:
        sums.append(torch.sum(origin_loc * origin_loc))
    norm_d, *rest = torch.sqrt(coll.all_reduce(torch.stack(sums)))
    norm_origin = rest[0] if rest else None
    setup = coll.counts()

    # The init is drawn at the unpadded shape, so that one seed gives the
    # single-device solver's init; the sharded core is zero-padded (C's
    # padded frames must be zero: GramC is reduced before the first C solve).
    a0, b0, c0 = interop.factors_from_numpy(*init, dtype=dtype)
    if coll.shard_mode == 1:
        if a0.shape[0] not in (n_orig, target):
            raise ValueError(f"a0 has {a0.shape[0]} rows, want {n_orig} (or {target}, padded)")
        a0 = _pad_with(a0, 0, target, 0)[lo:hi]
    else:
        c0 = _pad_with(c0, 2, target, 0)[:, :, lo:hi]
    state = init_state(d_loc, cfg, (a0, b0, c0))
    # the loop reads D every iteration: store it narrow too (norm_d above is
    # taken from the full-precision copy, as in tritd_admm)
    d_loc = narrow_cast(d_loc, cfg.torch_storage_dtype())
    sync(state)
    t0 = time.perf_counter()
    state = sync(run_admm(d_loc, state, cfg, mask=mask_loc, origin=origin_loc,
                          norm_d=norm_d, norm_origin=norm_origin, shard=coll))
    counts = {
        "setup": {k: setup[k] - before[k] for k in setup},
        "per_iter": {k: (v - setup[k]) // max(state.k, 1) for k, v in coll.counts().items()},
        "n_iters": state.k,
        # the loop alone: the slab's transfer before it and the assembly
        # after it are outside
        "loop_seconds": time.perf_counter() - t0,
    }
    return state, (lo, hi, target, n_orig), counts


def _assemble(x_loc: torch.Tensor, axis: int, bounds, group) -> torch.Tensor:
    """The full tensor on every rank from each rank's shard along `axis`, cut
    back to the unpadded size: a zero-filled buffer holding the shard, summed
    over `group` (a sum, not a gather: gloo gathers no CUDA tensors)."""
    lo, hi, target, n_orig = bounds
    if dist.get_world_size(group) == 1:
        return x_loc
    shape = list(x_loc.shape)
    shape[axis] = target
    full = torch.zeros(shape, dtype=x_loc.dtype, device=x_loc.device)
    full.narrow(axis, lo, hi - lo).copy_(x_loc)
    dist.all_reduce(full, group=group)
    return full if target == n_orig else full.narrow(axis, 0, n_orig).contiguous()


def _result(state, cfg: TriTDConfig, mode: int, bounds, group) -> TriTDResult:
    """The state as a result with full-size tensors on every rank; narrow
    stores are widened before they travel."""
    dtype = cfg.torch_dtype()
    axis = 0 if mode == 1 else 2
    a, c = state.a, state.c
    if mode == 1:
        a = _assemble(a, 0, bounds, group)
    else:
        c = _assemble(c, 2, bounds, group)
    return TriTDResult(
        a=a, b=state.b, c=c,
        o=_assemble(state.o.to(dtype), axis, bounds, group),
        e=_assemble(state.e.to(dtype), axis, bounds, group),
        err_hist=state.err_hist[: cfg.max_iter],
        rre_hist=state.rre_hist[: cfg.max_iter],
        n_iters=min(state.k, cfg.max_iter),
    )


def tritd_admm_sharded(
    d,
    cfg: TriTDConfig,
    mesh_or_group,
    shard_tensor_mode: int = 1,
    mask=None,
    origin=None,
    init=None,
    generator: torch.Generator | None = None,
    device=None,
    audit: dict | None = None,
) -> TriTDResult:
    """Sharded robust TriTD-ADMM; every rank of the slab group calls it with
    the same arguments. shard_tensor_mode=1 shards mode-1 slabs (rows i and
    the A core); 3 shards mode-3 frames (and the C core).

    Args:
      d: the full tensor (n1, n2, n3), numpy or a tensor, the same on every
        rank; a rank moves only its slab to its device.
      mesh_or_group: a `DeviceMesh` with a "slab" axis
        (:func:`tritd_tpu_torch.parallel.make_mesh`) or a process group.
      mask: bool tensor of *observed* entries (required iff cfg.masked).
      origin: optional ground truth; rre_hist records ||L - origin|| /
        ||origin|| per iteration (NaN when absent).
      init: optional factor init (a0, b0, c0) at the unpadded shape;
        `generator`: CPU generator for it otherwise (default: seed 0). Both
        as in :func:`tritd_tpu_torch.solvers.tritd_admm`, so one seed gives
        one trajectory whatever the shard count.
      device: where this rank keeps its slab; default: the mesh's device
        type (the current CUDA device), or d's device with a bare group.
      audit: optional dict, filled with the `all_reduce` calls, words and
        bytes of the set-up (`setup`) and of one iteration (`per_iter`),
        `n_iters`, and `loop_seconds` (host clock around the loop alone).

    Semantics are those of `tritd_admm` up to the order of sums. The result
    holds full-size tensors on every rank, on the rank's device.
    """
    _check_mask(cfg, mask)
    coll = SlabCollective(_slab_group(mesh_or_group), shard_tensor_mode)
    device = _shard_device(mesh_or_group, d, device)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = init_factors(generator, tuple(d.shape), cfg.rank, cfg.torch_dtype())
    state, bounds, counts = _local_solve(d, cfg, coll, mask, origin, init, device)
    if audit is not None:
        audit.update(n_shards=coll.size, **counts)
    return _result(state, cfg, shard_tensor_mode, bounds, coll.group)


def tritd_admm_batch_sharded(
    d_batch,
    cfg: TriTDConfig,
    mesh,
    mask_batch=None,
    origin_batch=None,
    init=None,
    generator: torch.Generator | None = None,
    device=None,
    audit: dict | None = None,
) -> TriTDResult:
    """A batch of independent TriTD problems, data-parallel over the mesh's
    "data" axis, each problem's mode-1 slabs sharded over the "slab" axis:
    DP x TP on a 2-D mesh. A data group takes batch / n_data consecutive
    entries and solves them one after another, each with its own early
    stop. Every rank of the mesh calls this with the same arguments.

    init: optional (a0, b0, c0) with the batch axis first. A's init is
    overwritten by the first solve and read before that only by masked
    imputation; a0 may have n1 rows or, as the reference draws it, n1 padded
    to a multiple of the slab count. Default: drawn entry by entry from
    `generator` (seed 0) at the unpadded shape.

    audit: as in :func:`tritd_admm_sharded`, with `n_iters` and
    `loop_seconds` summed over this rank's entries.

    The result's fields carry the batch axis first, full size on every rank.
    """
    _check_mask(cfg, mask_batch, "mask_batch")
    dtype = cfg.torch_dtype()
    n_data = mesh[DATA_AXIS].size()
    nb = d_batch.shape[0]
    if nb % n_data:
        raise ValueError(f"batch {nb} not divisible by data axis {n_data}")
    per = nb // n_data
    first = mesh.get_local_rank(DATA_AXIS) * per
    slab_group, data_group = mesh.get_group(AXIS), mesh.get_group(DATA_AXIS)
    coll = SlabCollective(slab_group, 1)
    device = _shard_device(mesh, d_batch, device)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # every rank draws every entry's init, so the streams agree
        draws = [init_factors(generator, tuple(d_batch.shape[1:]), cfg.rank, dtype) for _ in range(nb)]
        init = tuple(torch.stack(f) for f in zip(*draws))

    def entry(x, i):
        return None if x is None else x[i]

    mine = {}
    for i in range(first, first + per):
        state, bounds, counts = _local_solve(d_batch[i], cfg, coll, entry(mask_batch, i), entry(origin_batch, i),
                                             tuple(f[i] for f in init), device)
        mine[i] = _result(state, cfg, 1, bounds, slab_group)
        if audit is not None:
            for key in ("n_iters", "loop_seconds"):
                counts[key] += audit.get(key, 0)
            audit.update(n_shards=coll.size, **counts)

    # every rank holds its group's entries in full; the data groups swap
    # theirs through a zero-filled batch buffer, summed over the data axis
    fields = {}
    sample = next(iter(mine.values()))
    for name in TriTDResult._fields:
        one = torch.as_tensor(getattr(sample, name), device=device)
        full = torch.zeros((nb, *one.shape), dtype=one.dtype, device=device)
        for i, res in mine.items():
            full[i] = torch.as_tensor(getattr(res, name), device=device)
        if n_data > 1:
            dist.all_reduce(full, group=data_group)
        fields[name] = full
    return TriTDResult(**fields)
