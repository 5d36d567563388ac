"""Multi-device TriTD-ADMM: mode-1 slab / mode-3 frame sharding over a
`torch.distributed` process group.

PyTorch counterpart of `tritd_tpu/parallel/sharded_admm.py`. The reference
is one program (`shard_map` over a `Mesh`, `jax.lax.psum` inside a
`while_loop`); here every shard is a process of an SPMD program, holds its
slab on its own device, and completes sums with `dist.all_reduce` in the
loop of :func:`tritd_tpu_torch.solvers.admm.run_admm`. The iteration is the
single-device one, told where sums are completed (:class:`SlabCollective`);
it is not written out a second time.

Over NCCL on CUDA devices the loop is the reference's device-resident one:
the penalties and the counter live on the card, and each iteration after
the first is one replay of a CUDA graph that holds its `all_reduce` calls;
the host reads only the stop flag between iterations. Over gloo, which
passes a CUDA tensor's collective through the host, it is the eager loop.
Both give the same bits. As the reference's sharded `while_loop`
(`tritd_tpu/parallel/sharded_admm.py:152-209`), the loop takes one
iteration a step and tests the stop rule after each, whatever
`cfg.unroll`; only `tritd_admm_auto`, whose reference is `tritd_admm`,
runs blocks of `cfg.unroll`.

`tritd_admm_batch_sharded` solves a data group's entries in one loop, the
reference's `jax.vmap` of that `while_loop`: every entry in the same
batched operations, one launch of the elementwise kernel's batched entry an
iteration, the four `all_reduce` calls carrying the stacked sums, each
entry stopping on its own (`solvers.admm.run_admm_batch`).

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

:func:`tritd_admm_auto` takes the call of the reference's GSPMD entry point
(which hands the single-device program to XLA's SPMD partitioner) and runs it
on the explicit mode-1 path here: PyTorch has no partitioner that covers this
solver's operations.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from .. import interop
from ..ops.kruskal import input_device
from ..ops.narrow import narrow_cast
from ..solvers.admm import _graph_route, init_factors, init_state, run_admm, run_admm_batch
from ..solvers.base import TriTDConfig, TriTDResult
from ..utils.timing import sync
from .mesh import _pad_with, shard_bounds

AXIS = "slab"
DATA_AXIS = "data"


class SlabCollective:
    """Where the sums of a sharded iteration are completed: `all_reduce` over
    the process group `group`, for the layout `shard_mode` (1 or 3). Counts
    its calls and the words and bytes they carried in the dict `tally`; a
    CUDA graph that captures the calls counts them at each replay
    (`hopper_kernels.CountedGraph`), so the counts are the calls made."""

    def __init__(self, group, shard_mode: int):
        if shard_mode not in (1, 3):
            raise ValueError(f"shard_tensor_mode must be 1 or 3, got {shard_mode}")
        self.group = group
        self.shard_mode = shard_mode
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.tally = {"calls": 0, "words": 0, "bytes": 0}

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the group's collectives: NCCL's
        run on the card; gloo passes a CUDA tensor through the host. The
        answer is the group's, so every rank of it gets the same one."""
        return dist.get_backend(self.group) == "nccl"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the shards, on its device, in place; returns the sum."""
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        self.tally["calls"] += 1
        self.tally["words"] += x.numel()
        self.tally["bytes"] += x.numel() * x.element_size()
        return x

    def counts(self) -> dict:
        return dict(self.tally)


def _slab_group(mesh_or_group, axis_name: str = AXIS):
    """The process group of a DeviceMesh's `axis_name` dimension, or the
    group itself."""
    if isinstance(mesh_or_group, dist.ProcessGroup):
        return mesh_or_group
    return mesh_or_group.get_group(axis_name)


def _shard_device(mesh_or_group, d, device) -> torch.device:
    """The device this rank keeps its slab on: `device` when given; else the
    current device of the mesh's device type; else, for a bare group, the
    current CUDA device under NCCL (which reduces nothing on the CPU), and
    otherwise where the solvers put `d` (a tensor's device; the card for
    numpy, `RuntimeError` without CUDA)."""
    if device is not None:
        return torch.device(device)
    if not isinstance(mesh_or_group, dist.ProcessGroup):
        kind = mesh_or_group.device_type
        return torch.device(kind, torch.cuda.current_device()) if kind == "cuda" else torch.device(kind)
    if dist.get_backend(mesh_or_group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return input_device(d)


def _check_mask(cfg: TriTDConfig, mask, name: str = "mask") -> None:
    if cfg.masked and mask is None:
        raise ValueError(f"cfg.masked=True requires a {name} argument")
    if mask is not None and not cfg.masked:
        raise ValueError(f"{name} given but cfg.masked=False — pass TriTDConfig(masked=True)")


def _slab_of(coll: SlabCollective, n_orig: int) -> tuple:
    """(lo, hi, padded size, original size) of this rank's shard of an axis
    of n_orig entries, padded to a multiple of the shard count."""
    target = -(-n_orig // coll.size) * coll.size
    lo, hi = shard_bounds(target, coll.size, coll.index)
    return lo, hi, target, n_orig


def _local(x, axis: int, bounds, fill, dtype, device) -> torch.Tensor:
    """This rank's slab of `x` along `axis` on `device` in `dtype`: cut from
    what exists of it, moved alone, the rest padded with `fill`."""
    lo, hi, _target, n_orig = bounds
    x = torch.as_tensor(x).narrow(axis, min(lo, n_orig), max(min(hi, n_orig) - lo, 0))
    return _pad_with(narrow_cast(x.to(device), dtype), axis, hi - lo, fill).contiguous()


def _local_solve(d, cfg: TriTDConfig, coll: SlabCollective, mask, origin, init, device, _eager: bool = False,
                 unroll: int = 1, batched: bool = False):
    """Solve on this rank's shard. Returns the final state (its sharded
    tensors local), (lo, hi, padded size, original size) of the shard along
    the sharded axis, and the audit: the collective's counts in the set-up
    (the norms' one vector) and in one iteration (every iteration makes the
    same calls), the iterations done and the loop's seconds on the host
    clock, the device synchronized before and after. `unroll`: the
    iterations the loop runs between two reads of the stop flag, 1 as in
    the reference's sharded `while_loop` (histories max_iter long);
    `tritd_admm_auto` passes cfg.unroll. `_eager=True` keeps the loop off
    the CUDA graph route (see `run_admm`), to compare the two; every rank
    must pass the same.

    `batched` (mode-1 slabs): `d` (B, n1, n2, n3) and the init's factors
    stack a data group's entries, solved in one loop (`run_admm_batch`,
    one iteration a step) with each entry's norms; then the result is that
    loop's TriTDResult and the audit's `n_iters` counts the loop's steps."""
    cfg = dataclasses.replace(cfg, unroll=1 if batched else unroll)
    dtype = cfg.torch_dtype()
    lead = 1 if batched else 0  # the batch axis
    axis = lead + (0 if coll.shard_mode == 1 else 2)
    before = coll.counts()
    bounds = _slab_of(coll, d.shape[axis])
    lo, hi, target, n_orig = bounds
    d_loc = _local(d, axis, bounds, 0, dtype, device)
    mask_loc = None if mask is None else _local(mask, axis, bounds, True, torch.bool, device)
    origin_loc = None if origin is None else _local(origin, axis, bounds, 0, dtype, device)

    # the norms of the whole tensor (of each entry's), reduced once, as sums of squares
    def squares(x):
        return torch.stack([torch.sum(y * y) for y in x]) if batched else torch.sum(x * x)

    sums = [squares(d_loc)]
    if origin_loc is not None:
        sums.append(squares(origin_loc))
    norm_d, *rest = torch.sqrt(coll.all_reduce(torch.stack(sums)))
    norm_origin = rest[0] if rest else None
    setup = coll.counts()

    # The init is drawn at the unpadded shape, so that one seed gives the
    # single-device solver's init; the sharded core is zero-padded (C's
    # padded frames must be zero: GramC is reduced before the first C solve).
    a0, b0, c0 = interop.factors_from_numpy(*init, device=device, dtype=dtype)
    if coll.shard_mode == 1:
        if a0.shape[lead] not in (n_orig, target):
            raise ValueError(f"a0 has {a0.shape[lead]} rows, want {n_orig} (or {target}, padded)")
        a0 = _pad_with(a0, lead, target, 0).narrow(lead, lo, hi - lo)
    else:
        c0 = _pad_with(c0, 2, target, 0)[:, :, lo:hi]
    state = init_state(d_loc, cfg, (a0, b0, c0))
    # the loop reads D every iteration: store it narrow too (norm_d above is
    # taken from the full-precision copy, as in tritd_admm)
    d_loc = narrow_cast(d_loc, cfg.torch_storage_dtype())
    sync(state)
    t0 = time.perf_counter()
    if batched:
        state = sync(run_admm_batch(d_loc, state, cfg, coll, mask=mask_loc, origin=origin_loc, norm_d=norm_d,
                                    norm_origin=norm_origin, graphs=_graph_route(device, coll, _eager)))
        steps = max(state.n_iters)
    else:
        state = sync(run_admm(d_loc, state, cfg, mask=mask_loc, origin=origin_loc,
                              norm_d=norm_d, norm_origin=norm_origin, shard=coll, _eager=_eager))
        steps = state.k
    counts = {
        "setup": {k: setup[k] - before[k] for k in setup},
        "per_iter": {k: (v - setup[k]) // max(steps, 1) for k, v in coll.counts().items()},
        "n_iters": steps,
        # the loop alone: the slab's transfer before it and the assembly
        # after it are outside
        "loop_seconds": time.perf_counter() - t0,
    }
    return state, bounds, counts


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
    axis_name: str = AXIS,
) -> TriTDResult:
    """Sharded robust TriTD-ADMM; every rank of the slab group calls it with
    the same arguments. shard_tensor_mode=1 shards mode-1 slabs (rows i and
    the A core); 3 shards mode-3 frames (and the C core).

    Args:
      d: the full tensor (n1, n2, n3), numpy or a tensor, the same on every
        rank; a rank moves only its slab to its device.
      mesh_or_group: a `DeviceMesh` with an `axis_name` dimension ("slab",
        :func:`tritd_tpu_torch.parallel.make_mesh`) or a process group.
      mask: bool tensor of *observed* entries (required iff cfg.masked).
      origin: optional ground truth; rre_hist records ||L - origin|| /
        ||origin|| per iteration (NaN when absent).
      init: optional factor init (a0, b0, c0) at the unpadded shape;
        `generator`: CPU generator for it otherwise (default: seed 0). Both
        as in :func:`tritd_tpu_torch.solvers.tritd_admm`, so one seed gives
        one trajectory whatever the shard count.
      device: where this rank keeps its slab; default: the mesh's device
        type (the current CUDA device); with a bare group the current CUDA
        device under NCCL, else a tensor d's device, or the card for numpy
        (`RuntimeError` without CUDA: pass `device="cpu"`).
      audit: optional dict, filled with the `all_reduce` calls, words and
        bytes of the set-up (`setup`) and of one iteration (`per_iter`),
        `n_iters`, and `loop_seconds` (host clock around the loop alone).

    Semantics are those of `tritd_admm` up to the order of sums. The result
    holds full-size tensors on every rank, on the rank's device.
    """
    return _sharded(d, cfg, mesh_or_group, shard_tensor_mode, mask, origin, init, generator, device, audit,
                    axis_name, unroll=1)


def _sharded(d, cfg, mesh_or_group, shard_tensor_mode, mask, origin, init, generator, device, audit, axis_name,
             unroll):
    """`tritd_admm_sharded`, its loop reading the stop flag every `unroll`
    iterations (`_local_solve`)."""
    _check_mask(cfg, mask)
    coll = SlabCollective(_slab_group(mesh_or_group, axis_name), shard_tensor_mode)
    device = _shard_device(mesh_or_group, d, device)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = init_factors(generator, tuple(d.shape), cfg.rank, cfg.torch_dtype(), "cpu")
    state, bounds, counts = _local_solve(d, cfg, coll, mask, origin, init, device, unroll=unroll)
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
    data_axis: str = DATA_AXIS,
    slab_axis: str = AXIS,
    _serial: bool = False,
) -> TriTDResult:
    """A batch of independent TriTD problems, data-parallel over the mesh's
    `data_axis` dimension, each problem's mode-1 slabs sharded over its
    `slab_axis`: DP x TP on a 2-D mesh. A data group takes batch / n_data
    consecutive entries and solves them in one loop, each entry with its own
    early stop, as the reference's vmapped `while_loop` does
    (`_local_solve(..., batched=True)`; on the CUDA graph route over NCCL). Every rank of
    the mesh calls this with the same arguments. `_serial=True` solves the
    group's entries one after another instead, each as
    `tritd_admm_sharded` would: the comparison for the batched loop.

    init: optional (a0, b0, c0) with the batch axis first. A's init is
    overwritten by the first solve and read before that only by masked
    imputation; a0 may have n1 rows or, as the reference draws it, n1 padded
    to a multiple of the slab count. Default: drawn entry by entry from
    `generator` (seed 0) at the unpadded shape.

    audit: the `all_reduce` calls, words and bytes of the set-up and of one
    loop step (`setup`, `per_iter`, for the data group's entries together;
    serially, one entry's), the loop steps (`steps`), `n_iters` of every
    entry of the batch, and `loop_seconds` (host clock around this rank's
    loops).

    The result's fields carry the batch axis first, full size on every rank.
    """
    _check_mask(cfg, mask_batch, "mask_batch")
    dtype = cfg.torch_dtype()
    n_data = mesh[data_axis].size()
    nb = d_batch.shape[0]
    if nb % n_data:
        raise ValueError(f"batch {nb} not divisible by data axis {n_data}")
    per = nb // n_data
    first = mesh.get_local_rank(data_axis) * per
    slab_group, data_group = mesh.get_group(slab_axis), mesh.get_group(data_axis)
    coll = SlabCollective(slab_group, 1)
    device = _shard_device(mesh, d_batch, device)
    if init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # every rank draws every entry's init, so the streams agree
        draws = [init_factors(generator, tuple(d_batch.shape[1:]), cfg.rank, dtype, "cpu") for _ in range(nb)]
        init = tuple(torch.stack(f) for f in zip(*draws))

    def mine(x):
        return None if x is None else x[first:first + per]

    if _serial:
        results, counts = [], {"steps": 0, "loop_seconds": 0.0}
        for i in range(first, first + per):
            state, bounds, one = _local_solve(d_batch[i], cfg, coll, None if mask_batch is None else mask_batch[i],
                                              None if origin_batch is None else origin_batch[i],
                                              tuple(f[i] for f in init), device)
            results.append(_result(state, cfg, 1, bounds, slab_group))
            counts.update(setup=one["setup"], per_iter=one["per_iter"], steps=counts["steps"] + one["n_iters"],
                          loop_seconds=counts["loop_seconds"] + one["loop_seconds"])
        group = TriTDResult(*(torch.stack([torch.as_tensor(getattr(r, f), device=device) for r in results])
                              for f in TriTDResult._fields))
    else:
        res, bounds, counts = _local_solve(mine(d_batch), cfg, coll, mine(mask_batch), mine(origin_batch),
                                           tuple(mine(f) for f in init), device, batched=True)
        counts["steps"] = counts.pop("n_iters")
        group = res._replace(a=_assemble(res.a, 1, bounds, slab_group), o=_assemble(res.o, 1, bounds, slab_group),
                             e=_assemble(res.e, 1, bounds, slab_group),
                             n_iters=torch.tensor(res.n_iters, device=device))

    # every rank holds its group's entries in full; the data groups swap
    # theirs through a zero-filled batch buffer, summed over the data axis
    fields = {}
    for name in TriTDResult._fields:
        part = getattr(group, name)
        full = torch.zeros((nb, *part.shape[1:]), dtype=part.dtype, device=device)
        full[first:first + per] = part
        if n_data > 1:
            dist.all_reduce(full, group=data_group)
        fields[name] = full
    if audit is not None:
        audit.update(n_shards=coll.size, n_iters=fields["n_iters"].tolist(), **counts)
    return TriTDResult(**fields)


def tritd_admm_auto(
    d,
    cfg: TriTDConfig,
    mesh,
    generator: torch.Generator | None = None,
    axis_name: str = AXIS,
    mask=None,
    origin=None,
    init=None,
    device=None,
    audit: dict | None = None,
) -> TriTDResult:
    """The reference's GSPMD entry point (`tritd_tpu.parallel.tritd_admm_auto`)
    on the explicit collective path: no partitioner places anything here;
    mode-1 slabs go over the mesh's `axis_name` dimension through
    :func:`tritd_admm_sharded`, whose all_reduce calls are written out.

    The contract is the reference's: mode 1 is padded to a multiple of the
    slab count with zeros, `mask` with True (an observed zero) and `origin`
    with zeros, so the padded slab is inert; the result is cut back to n1.
    `generator`, `init`, `device` and `audit` are those of
    :func:`tritd_admm_sharded` (`generator` in place of the reference's
    `key`): the default init is tritd_admm's at the unpadded shape, and an
    `a0` may also carry the padded rows, as the reference draws it.

    The reference's auto is `tritd_admm` on the padded tensor, whose loop
    tests the stop rule every `cfg.unroll` iterations (an early stop may
    come up to unroll-1 iterations late): so does this one, where the
    sharded solve tests it after every iteration."""
    return _sharded(d, cfg, mesh, 1, mask, origin, init, generator, device, audit, axis_name, unroll=cfg.unroll)
