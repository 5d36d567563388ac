"""The fused elementwise ADMM block: hand-written Hopper kernel + plain version.

PyTorch counterpart of `tritd_tpu/ops/pallas_kernels.py`. Per iteration the
solver ends with one pass over D, L, E, Y_L, Y_O:

    r1 = D - L + Y_L/muL            o  = (muL*r1 + muO*r2)/(muL+muO)
    r2 = E - Y_O/muO                e  = soft(o + Y_O/muO, lam/muO)
    res_l = D - L - o               Y_L += muL*res_l
    res_o = o - e                   Y_O += muO*res_o
    ||res_l||^2, ||res_o||^2

and, when `mu_l_next` is given, the next factor-solve target
T' = D - O' + Y_L'/muL_next (`tritd_tpu/solvers/admm.py:156-163`), built
from O' and Y_L' as stored.

The dtypes follow the tensors, as in the reference's narrow-storage mode
(`_block_jnp(compute_dtype=..., store_dtype=...)`): L is in the compute
dtype, which the arithmetic and the two sums use; E, Y_L, Y_O and the four
outputs are in the storage dtype; D is in either; T' is in `t_dtype`
(default: the storage dtype). Beside the compute dtype, storage and T' may
be bfloat16, float16, float8_e4m3fn, float8_e5m2 or the other of float32
and float64, each rounded into as `ops.narrow.narrow_cast` rounds (the
reference's `astype`). The kernel has one instantiation per combination in
`KERNEL_VARIANTS` and rejects the rest. `flat_elementwise_block` is the
reference's own signature over the same kernel
(`tritd_tpu_torch.ops.elementwise_block`).

Routing is by device, with no fallback: CPU tensors take `_block_torch`,
CUDA tensors take `_block_cuda`, the kernel in `csrc/elementwise_block.cuh`
(its entry points in `csrc/elementwise_block*.cu`).
lam is a host number. The penalties muL, muO and muL_next are host numbers,
which the kernel takes by value, or 0-d tensors on the data's device, which
its pointer entry reads from device memory when it runs: the form a CUDA
graph replays with the penalties of each replay (`solvers/admm.py`). Both
forms round them to the compute dtype and combine them in it (lam/muO,
muL+muO), as the reference does in float32, and store the same bits.

`elementwise_block_batch` is the block over a stack of B independent
entries, the counterpart of the reference's `jax.vmap` of the block: one
launch of the kernel's batched entry, the penalties and the two sums one
per entry, each entry's stores and sums those of a launch on it alone.

The kernel's launch plan is made here, in plain functions of integers:
`group_size` (elements a thread takes per turn, so that the narrowest stream
moves 16 bytes), `block_grid` (one resident wave of blocks that all make the
same number of turns; a function of n alone, so the two sums are the same
from run to run) and `pointers_aligned` (16-byte accesses need every pointer
16-byte aligned; a contiguous view that is not takes the kernel's
one-element path, it is neither refused nor copied).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import time

import numpy as np
import torch

from .kruskal import on_input_device
from .narrow import FLOAT8, narrow_cast
from .shrinkage import soft_threshold

_F32, _F64 = torch.float32, torch.float64
# the narrow dtypes by the tag a variant's name gives them
_NARROW_TAGS = {
    "bf16": torch.bfloat16,
    "f16": torch.float16,
    "e4m3": torch.float8_e4m3fn,
    "e5m2": torch.float8_e5m2,
}


def _variants() -> dict:
    """(compute, D, storage, T') -> variant, for every combination
    tritd_admm produces with storage_dtype and einsum_dtype each None, one
    of the narrow dtypes or one of float32 and float64. Beside compute
    dtype C, a storage dtype X is a narrow one or W, the wide dtype that is
    not C (float64 beside float32, float32 beside float64): storage X
    unmasked (D stored in X; T' in the einsum dtype when one is set, which
    may be any narrow dtype, W or C itself, else X) and masked (the imputed
    D in C, no T'), and the einsum dtype alone, narrow or W (storage in C,
    T' in it). The name tags each dtype: 32 or 64 for float32 and float64,
    bf16, f16, e4m3, e5m2 for the narrow ones. The C entry point is
    `tritd_elementwise_block_<variant>`."""
    table = {(_F32,) * 4: "f32", (_F64,) * 4: "f64"}
    for bits, cd, wide_bits, wide in (("32", _F32, "64", _F64), ("64", _F64, "32", _F32)):
        stored = {**_NARROW_TAGS, wide_bits: wide}
        for tag, x in stored.items():
            table[(cd, x, x, x)] = f"c{bits}_d{tag}_s{tag}_t{tag}"
            table[(cd, cd, x, x)] = f"c{bits}_d{bits}_s{tag}_t{tag}"
            table[(cd, cd, cd, x)] = f"c{bits}_d{bits}_s{bits}_t{tag}"
        for s_tag, s_dt in stored.items():
            for t_tag, t_dt in {**stored, bits: cd}.items():
                if s_tag != t_tag:
                    table[(cd, s_dt, s_dt, t_dt)] = f"c{bits}_d{s_tag}_s{s_tag}_t{t_tag}"
    return table


KERNEL_VARIANTS = _variants()

# Launches of each variant of the hand-written kernel, counted where the
# wrapper launches it, through either single-entry entry point;
# POINTER_LAUNCHES counts those of them through the pointer entry;
# BATCH_LAUNCHES the launches of the batched entry (one for a whole batch).
LAUNCHES = {f"elementwise_block[{v}]": 0 for v in KERNEL_VARIANTS.values()}
POINTER_LAUNCHES = {f"elementwise_block_ptr[{v}]": 0 for v in KERNEL_VARIANTS.values()}
BATCH_LAUNCHES = {f"elementwise_block_batch[{v}]": 0 for v in KERNEL_VARIANTS.values()}
# Launches of SOFIA's kernels (`ops/sofia_kernels.py`), by dtype.
SOFIA_LAUNCHES = {f"{name}[{dt}]": 0 for name in ("pinv_rows", "mode3_sweep", "gauss_seidel_sweep")
                  for dt in ("f32", "f64")}
# Calls of the cuSOLVER drivers behind `ops/device_linalg.py`, by dtype: no
# kernel of this package, counted the same way (a graph's replays too).
LINALG_CALLS = {f"{name}[{dt}]": 0 for name in ("xsyevbatched", "xsyevd", "gesvdj")
                for dt in ("f32", "f64")}
# Launches of the hand-written Jacobi SVD (`ops/device_linalg.py::jacobi_svd`,
# `csrc/jacobi_svd.cu`), by dtype: one a call, its whole sequence of sweeps.
JACOBI_SVD_LAUNCHES = {f"jacobi_svd[{dt}]": 0 for dt in ("f32", "f64")}
_COUNTS = (LAUNCHES, POINTER_LAUNCHES, BATCH_LAUNCHES, SOFIA_LAUNCHES, LINALG_CALLS, JACOBI_SVD_LAUNCHES)


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def graph_nodes():
    """Around the capture of a CUDA graph: the wrapper calls inside record
    kernel nodes, which launch nothing until the graph is replayed. Yields a
    dict that receives {count key: nodes} when the block ends, and leaves
    the counts as they were before; `count_replay(nodes)` then counts each
    replay's launches."""
    before = {key: n for counts in _COUNTS for key, n in counts.items()}
    nodes: dict = {}
    try:
        yield nodes
    finally:
        for counts in _COUNTS:
            nodes.update({key: n - before[key] for key, n in counts.items() if n != before[key]})
            counts.update({key: before[key] for key in counts})


def count_replay(nodes: dict) -> None:
    """Count the kernel launches of one replay of a graph with these nodes."""
    for key, n in nodes.items():
        next(counts for counts in _COUNTS if key in counts)[key] += n


class CountedGraph:
    """`fn()` captured as a CUDA graph on the current stream into the memory
    pool `pool`, and replayed with its kernel launches counted. The capture
    launches nothing and counts nothing; each `replay()` counts the wrapper
    calls the capture met. `tallies`: other dicts of counts that the calls
    inside add to (a collective's calls and words), taken the same way: the
    capture leaves each as it was, and each replay adds what the capture
    met. An error inside the capture (a host sync, an operation that cannot
    be captured) ends it and is raised. `capture_s`: the host seconds the
    capture took. Python's cyclic garbage collector is off during the
    capture: a CUDA graph it freed then (one held in a reference cycle)
    would be destroyed inside the capture, which invalidates it (cuBLAS
    then failed with CUBLAS_STATUS_EXECUTION_FAILED)."""

    def __init__(self, fn, pool, tallies=()):
        self.graph = torch.cuda.CUDAGraph()
        before = [dict(t) for t in tallies]
        start = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with graph_nodes() as self.nodes:
                self.graph.capture_begin(pool=pool)
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            self.tally_nodes = [(t, {key: n - b[key] for key, n in t.items()}) for t, b in zip(tallies, before)]
            for t, b in zip(tallies, before):
                t.update(b)
        self.capture_s = time.perf_counter() - start

    def replay(self) -> None:
        self.graph.replay()
        count_replay(self.nodes)
        for tally, nodes in self.tally_nodes:
            for key, n in nodes.items():
                tally[key] += n


# The kernel's geometry; `_entry` holds both against the built library.
BLOCK_THREADS = 256
# One wave that an H100 SXM holds at once: 132 SMs x 2 blocks of 256 threads
# (up to 128 registers a thread: with 4 blocks and 64 registers the groups of
# 8 spilled). Fixed, not read from the card, so that the grid, and with it
# the order of the two sums, is the same on every card.
RESIDENT_BLOCKS = 132 * 2
# doubles of scratch: a partial sum of each residual per block, and the counter
# (a batched launch: this much for each entry)
SCRATCH_LEN = 2 * RESIDENT_BLOCKS + 1
# entries of a batched launch: the grid's y dimension
MAX_BATCH = 65535


def group_size(widest_size: int, narrowest_size: int) -> int:
    """Elements a thread takes per turn on the vector path: 16 bytes of the
    narrowest stream, capped at 32 bytes of the widest type, which is the
    compute type but for float64 storage or T' beside float compute (4
    floats, 2 doubles, 8 bf16 beside float compute, 4 bf16 beside double or
    beside a double stream)."""
    return min(16 // narrowest_size, 32 // widest_size)


def block_grid(n: int, group: int) -> int:
    """Blocks of BLOCK_THREADS threads for n elements in groups of `group`:
    one group a thread while that fits in RESIDENT_BLOCKS, else the fewest
    whole turns t that fit and just enough blocks for t turns each, so no
    second, part-filled wave. Depends on n and the variant's group alone."""
    groups = -(-n // group)
    want = max(1, -(-groups // BLOCK_THREADS))
    if want <= RESIDENT_BLOCKS:
        return want
    turns = -(-want // RESIDENT_BLOCKS)
    return -(-want // turns)


VARIANT_GROUP = {
    variant: group_size(max(dt.itemsize for dt in key), min(dt.itemsize for dt in key))
    for key, variant in KERNEL_VARIANTS.items()
}


def pointers_aligned(*pointers: int) -> bool:
    """True if every address is a multiple of 16, the width of the kernel's
    vector accesses. What PyTorch allocates is; a view into it need not be."""
    bits = 0
    for p in pointers:
        bits |= p
    return bits & 15 == 0


# (device index, stream handle) -> the kernel's scratch: per-block partial
# sums and the ticket counter that the last block sets back to 0. Two
# streams that shared a counter would race, so each has its own; zeroed
# once, when made.
_SCRATCH: dict = {}


def _scratch_for(key, make):
    """The scratch kept under `key`, made by `make()` at first use. A graph
    bakes the scratch's address into its kernel nodes, so it must be made
    outside the capture: made during one, it would be zeroed by that
    graph's replays alone, and only kept alive by this dict."""
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the elementwise block's scratch for stream {key} must exist before a CUDA graph "
                               f"captures its launch: call the block once on that stream first")
        buf = _SCRATCH[key] = make()
    return buf


def _scalars(dtype: torch.dtype, *values):
    """Scalars in the tensor dtype: host numbers rounded to it as numpy
    scalars, 0-d tensors converted to it."""
    np_t = np.dtype(str(dtype).removeprefix("torch.")).type
    return tuple(None if v is None else v.to(dtype) if isinstance(v, torch.Tensor) else np_t(v) for v in values)


def _operand(x):
    """A scalar as an operand of tensor arithmetic: a host number as a
    Python float (exact: it holds a value of the compute dtype), a 0-d
    tensor as it is."""
    return x if isinstance(x, torch.Tensor) else float(x)


def _block_torch(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None,
                 compute_dtype=None, store_dtype=None, t_dtype=None, batched=False):
    """Plain PyTorch version: a line-for-line port of `_block_jnp`
    (`tritd_tpu/ops/pallas_kernels.py:45-66`), plus T'. compute_dtype
    defaults to d's dtype, t_dtype to the dtype the outputs are stored in.
    Stores round with `narrow_cast`, as the reference's `astype` does. The
    penalties may be host numbers or 0-d tensors on d's device (nothing is
    read back to the host); on the CPU the two forms give the same bits.
    `batched`: the five inputs stack B entries on their first axis, the
    penalties are (B,) tensors (one an entry, broadcast over it) and the two
    sums come back as (B,) tensors, each entry's sum taken alone."""
    cd = compute_dtype or d.dtype
    if batched:
        mu_l, mu_o, mu_l_next = (None if m is None else m.view(-1, *(1,) * (d.dim() - 1))
                                 for m in (mu_l, mu_o, mu_l_next))
    mu_l, mu_o, lam, mu_l_next = _scalars(cd, mu_l, mu_o, lam, mu_l_next)
    d, l, e, y_l, y_o = (x.to(cd) for x in (d, l, e, y_l, y_o))
    m_l, m_o = _operand(mu_l), _operand(mu_o)
    r1 = d - l + y_l / m_l
    r2 = e - y_o / m_o
    o = (m_l * r1 + m_o * r2) / _operand(mu_l + mu_o)
    # a host number over a tensor would be the number times the tensor's
    # reciprocal (Tensor.__rtruediv__): divide tensor by tensor
    thr = torch.div(mu_o.new_full((), float(lam)), mu_o) if isinstance(mu_o, torch.Tensor) else float(lam / mu_o)
    e_new = soft_threshold(o + y_o / m_o, thr)
    res_l = d - l - o
    res_o = o - e_new
    y_l_new = y_l + m_l * res_l
    y_o_new = y_o + m_o * res_o
    if batched:
        nl = torch.stack([torch.sum(r * r) for r in res_l])
        no = torch.stack([torch.sum(r * r) for r in res_o])
    else:
        nl = torch.sum(res_l * res_l)
        no = torch.sum(res_o * res_o)
    if store_dtype is not None:
        o, e_new, y_l_new, y_o_new = (narrow_cast(x, store_dtype) for x in (o, e_new, y_l_new, y_o_new))
    t_new = None
    if mu_l_next is not None:
        # from the stored O' and Y_L', as the reference's solver reads them
        t_new = narrow_cast(d - o.to(cd) + y_l_new.to(cd) / _operand(mu_l_next), t_dtype or o.dtype)
    return o, e_new, y_l_new, y_o_new, nl, no, t_new


# A narrow dtype's relative rounding step, 2**-p for p significand bits
# (the implicit one included): the tolerance of its outputs.
NARROW_ULP = {
    torch.bfloat16: 2.0**-8,
    torch.float16: 2.0**-11,
    torch.float8_e4m3fn: 2.0**-4,
    torch.float8_e5m2: 2.0**-3,
}
# Largest share of a narrow output whose rounding may differ from the plain
# version's, by dtype. An ulp of difference in the compute dtype (FMA
# contraction, PyTorch's CUDA division by a host scalar through its
# reciprocal) flips a bf16 rounding in up to 7.4e-5 of an output's elements
# with float32 compute on an H100 (most in Y_O', where O' - E' cancels) and
# in at most 4e-7 with float64, on random inputs. Truncating instead of rounding to
# nearest even flips 24-50% of them, and T' from the unrounded O' and Y_L'
# 36%. A flip needs the exact value within that ulp of one of the narrow
# format's ties, so the share scales with the density of its ties: float16,
# three significand bits more than bf16, flips 8 times as often (4.0e-4 of
# Y_O' at the taxi shape, 6.6e-4 at 17x23x31, on an NVIDIA H100 80GB HBM3
# at 700 W): its limit is bf16's times 8. The float8 formats, with fewer
# bits, keep bf16's. Small tensors may flip NARROW_FLIP_FLOOR elements
# whatever their size.
NARROW_FLIP_SHARE = {
    torch.bfloat16: 3e-4,
    torch.float16: 8 * 3e-4,
    torch.float8_e4m3fn: 3e-4,
    torch.float8_e5m2: 3e-4,
}
NARROW_FLIP_FLOOR = 4
# A float32 output beside float64 compute is, like a narrow one beside
# float32, one rounding of the compute dtype's value on both sides: held to
# one float32 step (the implicit bit included) with at most this share of
# its elements rounded otherwise. On random doubles an ulp of float64 would
# move a float32 rounding with odds of about 2**-29; but where every input
# holds a float32 value (all five of them in chip_smoke's phase 2) the exact
# result often lies on a float32 tie, and the ulp by which the kernel's
# division and fused products part from PyTorch's flipped 4.0e-3 of O'
# (NVIDIA H100 80GB HBM3 at 700 W, taxi shape; the same share on the CPU
# with the divisions taken through the reciprocal). A kernel that computed
# in float32 rounds about 63% of them otherwise.
F32_AT_F64_ULP = 2.0**-24
F32_AT_F64_FLIP_SHARE = 2e-2


def rounding_limits(dtype: torch.dtype, compute_dtype: torch.dtype) -> tuple[float, float] | None:
    """(step, share of elements that may round otherwise) an output stored
    in `dtype` beside `compute_dtype` is held to; None for an output that
    is the compute dtype or wider (held at rtol 1e-6)."""
    if dtype == torch.float32 and compute_dtype == _F64:
        return F32_AT_F64_ULP, F32_AT_F64_FLIP_SHARE
    if dtype in NARROW_ULP:
        return NARROW_ULP[dtype], NARROW_FLIP_SHARE[dtype]
    return None


def _differ(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Where two tensors of one dtype hold other values; NaN in both places
    counts as equal. Compared widened to float64, which every dtype here
    widens into exactly."""
    g, w = g.to(_F64), w.to(_F64)
    return (g != w) & ~(g.isnan() & w.isnan())


def check_narrow_against_plain(args, got, want, mu_l_next=None) -> dict:
    """Hold a narrow kernel variant's outputs `got` against the plain
    version's `want` (both tuples as `_block_torch` returns them, from the
    five inputs `args`). Raises AssertionError unless T' is bitwise the
    `narrow_cast` of D - O' + Y_L'/mu_l_next computed from the kernel's own
    stored O' and Y_L'; every output narrower than the compute dtype (a
    narrow one, or float32 beside float64: `rounding_limits`) differs from
    the plain one in at most its share of its elements (or
    NARROW_FLIP_FLOOR) and is within one of its steps of it (rtol step,
    atol step * max|input|), T' within that plus what the kernel's O' and
    Y_L'/mu_l_next differ by from the plain ones; and other outputs agree
    to rtol 1e-6. NaN in the same place on both sides counts as equal.
    Returns the largest absolute difference and the largest share of
    differently rounded elements."""
    d, cd = args[0], args[1].dtype
    # the largest finite input: a NaN or an infinity sets no scale
    scale = max(float(a.to(cd).abs().nan_to_num(0.0, 0.0, 0.0).max()) for a in args)
    idx = (0, 1, 2, 3) if mu_l_next is None else (0, 1, 2, 3, 6)
    names = ("o", "e", "y_l", "y_o", "nl", "no", "t")
    if mu_l_next is not None:
        mu = torch.tensor(mu_l_next, dtype=cd, device=d.device)  # true division, also on CUDA
        rebuilt = narrow_cast(d.to(cd) - got[0].to(cd) + got[2].to(cd) / mu, got[6].dtype)
        wrong = int(_differ(rebuilt, got[6]).sum())
        if wrong:
            raise AssertionError(f"t: {wrong} of {rebuilt.numel()} elements are not D - O' + Y_L'/mu_l_next "
                                 f"from the stored O' and Y_L'")
    max_abs, max_share = 0.0, 0.0
    for i in idx:
        g, w = got[i], want[i]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{names[i]}: {g.dtype}{tuple(g.shape)} vs plain {w.dtype}{tuple(w.shape)}")
        both_nan = g.to(cd).isnan() & w.to(cd).isnan()
        max_abs = max(max_abs, float(torch.where(both_nan, 0.0, (g.to(cd) - w.to(cd)).abs()).max()))
        limits = rounding_limits(g.dtype, cd)
        if limits is not None:
            flips = int(_differ(g, w).sum())
            max_share = max(max_share, flips / g.numel())
            limit = limits[1]
            if flips > max(NARROW_FLIP_FLOOR, limit * g.numel()):
                raise AssertionError(
                    f"{names[i]}: {flips} of {g.numel()} {g.dtype} elements rounded otherwise than the plain "
                    f"version (share {flips / g.numel():.2e}, limit {limit:.1e})")
        tol = 1e-6 if limits is None else limits[0]
        if i != 6:
            torch.testing.assert_close(g.to(cd), w.to(cd), rtol=tol, atol=tol * scale, equal_nan=True,
                                       msg=lambda m, n=names[i]: f"{n}: {m}")
            continue
        # T' = D - S(O') + S(Y_L')/mu_l_next also carries whatever the two
        # stores it is built from differ by (a rounding of O' or Y_L' flipped
        # by a step of the storage dtype, which may be coarser than T's)
        g, w = g.to(cd), w.to(cd)
        carried = _gap(got[0].to(cd), want[0].to(cd)) + _gap(got[2].to(cd), want[2].to(cd)) / mu_l_next
        allowed = tol * (scale + w.abs()) + carried
        bad = ~((g == w) | (g.isnan() & w.isnan()) | ((g - w).abs() <= allowed))
        if bad.any():
            k = int(torch.argmax(bad.to(torch.uint8)))
            raise AssertionError(
                f"t: {int(bad.sum())} of {g.numel()} elements differ from the plain version by more than one "
                f"rounding step ({tol:g}) and what O' and Y_L' differ by; e.g. element {k}: "
                f"{float(g.flatten()[k])} vs {float(w.flatten()[k])}, allowed {float(allowed.flatten()[k])}")
    return {"max_abs_err": max_abs, "flip_share": max_share}


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b|, 0 where the two are equal or both NaN."""
    return torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())


# Outputs at the edges of the narrow formats: the ends of the float8 ranges
# and past them (448, 464, just above 464, 480, 57344, 61440, +-inf), float8
# and float16 subnormals, and float64 values that one rounding and two
# (through float32) round apart.
EDGE_VALUES = [0.0, -0.0, 448.0, 449.0, 464.0, 464.00001, 465.0, 480.0, -500.0, 57344.0, 60000.0, 61439.0,
               61440.0, 61441.0, -70000.0, 65504.0, 65520.0, float("inf"), float("-inf"), float("nan"),
               2.0**-9, 2.0**-10, 3 * 2.0**-11, 2.0**-16, 2.0**-17, 3 * 2.0**-18, 2.0**-24, 2.0**-25,
               1 + 2.0**-11 + 2.0**-40, 1 + 2.0**-4 + 2.0**-40, 1 + 2.0**-3 + 2.0**-40,
               -(1 + 2.0**-4 + 2.0**-40), 1 + 2.0**-8 + 2.0**-40, 0.1, -3.3, 7.77]
# Scalars under which the block is exact on the inputs of `edge_args`.
EDGE_SCALARS = (0.5, 0.5, 0.0)  # mu_l, mu_o, lam
EDGE_MU_NEXT = 0.5


def edge_args(values, dtypes, device) -> list:
    """The five inputs of a variant with (compute, D, storage, T') `dtypes`
    under which the block's outputs are `values` before they are stored:
    D, E, Y_L and Y_O zero and L = -2 * values in the compute dtype. With
    EDGE_SCALARS every step is exact (O' = E' = v; for finite v, Y_L' = v/2,
    Y_O' = 0 and T' = 2 S(v/2) - S(v) with EDGE_MU_NEXT), so a store can
    differ from `narrow_cast` of its value only by the rounding: put the
    values at the edges of the narrow formats and the conversions are held
    bitwise."""
    cd, d_dt, s_dt, _t = dtypes
    l = (-2.0 * torch.as_tensor(values, dtype=_F64)).to(cd).to(device)
    zeros = torch.zeros_like(l)
    return [zeros.to(d_dt), l, *(zeros.to(s_dt) for _ in range(3))]


def float8_code_args(fmt, dtypes, device) -> list:
    """The five inputs of a variant with (compute, D, storage, T') `dtypes`
    that carry all 256 codes of the float8 dtype `fmt` (+-0, the subnormals,
    NaN, e5m2's infinities) as D, E, Y_L and Y_O: each of the four takes the
    codes in four orders of its own (permutations from a fixed seed) and
    a five-code tail for the kernel's one-element path; L is zero. An input
    of dtype `fmt` holds the codes bitwise, one of another dtype their
    values as `narrow_cast` rounds them. Under EDGE_SCALARS every product
    the block forms is exact (halving or doubling a float8 value), so the
    kernel rounds wherever the plain version does, and every store must
    equal the plain version's (`check_stores_bitwise`)."""
    cd, d_dt, s_dt, _t = dtypes
    rng = np.random.default_rng(256)
    codes = [np.concatenate([rng.permutation(256) for _ in range(4)] + [np.arange(5)]).astype(np.uint8)
             for _ in range(4)]

    def holding(c, dt):
        x = torch.from_numpy(c).view(fmt)
        return x if dt == fmt else narrow_cast(x.to(_F64), dt)

    d, e, y_l, y_o = (holding(c, dt) for c, dt in zip(codes, (d_dt, s_dt, s_dt, s_dt)))
    return [x.to(device) for x in (d, torch.zeros(d.shape, dtype=cd), e, y_l, y_o)]


def check_stores_bitwise(got, want) -> int:
    """Raise AssertionError unless each tensor output of `got` (a tuple as
    `_block_torch` returns it) holds the same values as `want`'s, NaN where
    `want` has NaN; `want` may lie on another device. Returns the number of
    elements compared."""
    names = ("o", "e", "y_l", "y_o", "nl", "no", "t")
    count = 0
    for i in (0, 1, 2, 3, 6):
        if got[i] is None and want[i] is None:
            continue
        g, w = got[i], want[i].to(got[i].device)
        if g.dtype != w.dtype:
            raise AssertionError(f"{names[i]}: {g.dtype} vs {w.dtype}")
        wrong = int(_differ(g, w).sum())
        if wrong:
            raise AssertionError(f"{names[i]}: {wrong} of {g.numel()} stores differ from the plain version's")
        count += g.numel()
    return count


def kernel_variant(d, l, e, y_l, y_o, t_dtype=None) -> str:
    """The kernel variant for these tensors' dtypes; TypeError if none."""
    if l.dtype not in (_F32, _F64):
        raise TypeError(f"elementwise_block kernel computes in float32 or float64 (L's dtype), got {l.dtype}")
    key = (l.dtype, d.dtype, e.dtype, t_dtype or e.dtype)
    if y_l.dtype != e.dtype or y_o.dtype != e.dtype or key not in KERNEL_VARIANTS:
        raise TypeError(
            f"elementwise_block kernel has no variant for these mixed dtypes: L {l.dtype}, "
            f"D {d.dtype}, E/Y_L/Y_O {e.dtype}/{y_l.dtype}/{y_o.dtype}, T' {key[3]}; "
            f"it takes (compute, D, storage, T') in {sorted(KERNEL_VARIANTS.values())}"
        )
    return KERNEL_VARIANTS[key]


def _check_kernel_inputs(tensors) -> None:
    d = tensors[0]
    shape, device = d.shape, d.device
    if device.type == "cuda" and all(
            x.shape == shape and x.device == device and x.is_contiguous() for x in tensors):
        return
    for x in tensors:
        if x.shape != shape:
            raise ValueError(f"mixed shapes: {tuple(x.shape)} vs {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError("elementwise_block kernel needs contiguous tensors")
    for x in tensors:
        if x.device.type != "cuda" or x.device != device:
            raise ValueError(f"elementwise_block kernel needs tensors on one CUDA device, got {x.device}")


@functools.cache
def _entry(variant: str):
    """(C entry point, group, launch-count key) of a variant, looked up once.
    Building and loading the library happens here, at the first CUDA call.
    Raises if the library was built with another geometry than this module's
    plan assumes."""
    from ..runtime import kernels

    lib = kernels.library()
    name = f"tritd_elementwise_block_{variant}"
    want = (BLOCK_THREADS, RESIDENT_BLOCKS, SCRATCH_LEN, VARIANT_GROUP[variant])
    built = (lib.tritd_block_threads(), lib.tritd_max_blocks(), lib.tritd_scratch_len(),
             getattr(lib, f"{name}_group")())
    if built != want:
        raise RuntimeError(f"{name}: the library's threads, resident blocks, scratch length and group "
                           f"{built} differ from this module's {want}")
    return getattr(lib, name), want[3], f"elementwise_block[{variant}]"


@functools.cache
def _pointer_entry(variant: str):
    """The variant's pointer entry (`..._ptr`: the penalties read from
    device memory), looked up once, after `_entry` has checked the library."""
    from ..runtime import kernels

    _entry(variant)
    return getattr(kernels.library(), f"tritd_elementwise_block_{variant}_ptr")


@functools.cache
def _batch_entry(variant: str):
    """The variant's batched entry (`..._batch`), looked up once, after
    `_entry` has checked the library."""
    from ..runtime import kernels

    _entry(variant)
    return getattr(kernels.library(), f"tritd_elementwise_block_{variant}_batch")


def _check_out(out, like, t_like, inputs) -> None:
    """`out` = (o, e, y_l, y_o, t) buffers for the kernel's stores: each of
    the shape, dtype and device of the output it takes, contiguous, and
    none of them one of the inputs, which the kernel reads through
    restrict pointers. t is None without T'."""
    want = [like] * 4 + [t_like]
    if len(out) != 5 or (out[4] is None) != (t_like is None):
        raise ValueError("out takes (o, e, y_l, y_o, t), with t None exactly when no T' is built")
    taken = {x.data_ptr() for x in inputs}
    for buf, spec in zip(out, want):
        if buf is None:
            continue
        dtype, shape, device = spec
        if (buf.dtype, buf.shape, buf.device) != (dtype, shape, device) or not buf.is_contiguous():
            raise ValueError(f"out buffer {buf.dtype}{tuple(buf.shape)} on {buf.device}, contiguous "
                             f"{buf.is_contiguous()}: the kernel stores {dtype}{tuple(shape)} on {device}")
        if buf.data_ptr() in taken:
            raise ValueError("an out buffer is one of the block's inputs")


def _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None, t_dtype=None, out=None, batched=False):
    """Launch the variant's kernel (`csrc/elementwise_block.cuh`) on the
    current stream: one kernel. Returns the same tuple as `_block_torch`;
    the norms are views of one small tensor on the device, so nothing waits
    for the device. Host penalties are passed by value, rounded to the
    compute dtype; 0-d tensors go to the pointer entry by address (mu_l
    again in place of mu_l_next without T': a divisor the kernel then
    skips), converted to the compute dtype on the device where they are not
    in it. `batched`: the inputs stack B entries on their first axis and the
    penalties are (B,) tensors, which go to the batched entry by address;
    the norms are (B,). `out`: buffers the four outputs and T' are stored in
    (`_check_out`), else new tensors."""
    tensors = (d, l, e, y_l, y_o)
    # without T' its dtype is moot: the variant with T' in the storage dtype
    t_dtype = (t_dtype or e.dtype) if mu_l_next is not None else e.dtype
    variant = kernel_variant(*tensors, t_dtype=t_dtype)
    _check_kernel_inputs(tensors)
    device = d.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next, t_dtype=t_dtype, out=out,
                               batched=batched)
    fn, group, count_key = _entry(variant)
    with_t = mu_l_next is not None
    n_batch = d.shape[0] if batched else 1
    if batched and not (d.dim() >= 1 and 1 <= n_batch <= MAX_BATCH):
        raise ValueError(f"a batched block takes 1 to {MAX_BATCH} entries on the first axis, got shape "
                         f"{tuple(d.shape)}")
    n = d.numel() // n_batch
    if out is None:
        outs = [torch.empty_like(e) for _ in range(4)]
        t_new = None
        if with_t:
            t_new = torch.empty_like(e) if t_dtype == e.dtype else torch.empty_like(d, dtype=t_dtype)
    else:
        _check_out(out, (e.dtype, e.shape, device), (t_dtype, d.shape, device) if with_t else None, tensors)
        *outs, t_new = out
    o, e_new, y_l_new, y_o_new = outs
    sums = torch.empty((n_batch, 2) if batched else (2,), dtype=l.dtype, device=device)
    streams = [*tensors, *outs] + ([t_new] if with_t else [])
    pointers = [x.data_ptr() for x in streams]
    # a batch: each entry tests its own addresses in the kernel, as here
    aligned = () if batched else (pointers_aligned(*pointers),)
    if not with_t:
        pointers.append(None)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    key = (device.index, stream, n_batch) if batched else (device.index, stream)
    scratch = _scratch_for(key, lambda: torch.zeros(n_batch * SCRATCH_LEN, dtype=_F64, device=device))
    grid = (n, n_batch, block_grid(n, group)) if batched else (n, block_grid(n, group))
    head = (*pointers, sums.data_ptr(), scratch.data_ptr(), *grid, *aligned)
    if batched or isinstance(mu_l, torch.Tensor):
        mus = [x if x.dtype == l.dtype else x.to(l.dtype) for x in (mu_l, mu_o, mu_l_next if with_t else mu_l)]
        if batched and any(x.get_device() != device.index or x.shape != (n_batch,) or not x.is_contiguous()
                           for x in mus):
            raise ValueError(f"the penalties must be contiguous ({n_batch},) tensors on {device}, the block's device")
        if any(x.get_device() != device.index or (x.numel() != 1 and not batched) for x in mus):
            raise ValueError(f"the penalties must be 0-d tensors on {device}, the block's device")
        entry = _batch_entry(variant) if batched else _pointer_entry(variant)
        err = entry(*head, mus[0].data_ptr(), mus[1].data_ptr(), float(lam), mus[2].data_ptr(), stream)
    else:
        err = fn(*head, float(mu_l), float(mu_o), float(lam), float(mu_l_next) if with_t else 1.0, stream)
    if err:
        from ..runtime import kernels

        kernels.check(err, f"{count_key} launch")
    if batched:
        BATCH_LAUNCHES[f"elementwise_block_batch[{variant}]"] += 1
    else:
        LAUNCHES[count_key] += 1
        if isinstance(mu_l, torch.Tensor):
            POINTER_LAUNCHES[f"elementwise_block_ptr[{variant}]"] += 1
    nl, no = sums.unbind(-1)
    return o, e_new, y_l_new, y_o_new, nl, no, t_new


def elementwise_block(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None, t_dtype=None, out=None):
    """Fused O/E/dual/residual update. Returns
    (o, e_new, y_l_new, y_o_new, ||res_l||^2, ||res_o||^2, t_new), where
    t_new = D - O' + Y_L'/mu_l_next in `t_dtype` (default: E's dtype), or
    None when mu_l_next is None. Computes in L's dtype and stores the four
    tensor outputs in E's: in new tensors, or in `out` = (o, e, y_l, y_o, t)
    (t None without T'), none of them an input. The penalties are host
    numbers or 0-d tensors on d's device (module docstring)."""
    if d.device.type == "cpu":
        got = _block_torch(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next,
                           compute_dtype=l.dtype, store_dtype=e.dtype, t_dtype=t_dtype)
        if out is None:
            return got
        _check_out(out, (e.dtype, e.shape, d.device), None if got[6] is None else (got[6].dtype, d.shape, d.device),
                   (d, l, e, y_l, y_o))
        for buf, x in zip(out, (*got[:4], got[6])):
            if buf is not None:
                buf.copy_(x)
        return (*out[:4], got[4], got[5], out[4])
    if d.device.type == "cuda":
        return _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next, t_dtype=t_dtype, out=out)
    raise ValueError(f"elementwise_block runs on CPU or CUDA tensors, got {d.device}")


def elementwise_block_batch(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None, t_dtype=None, out=None):
    """`elementwise_block` over B independent entries stacked on the first
    axis of the five inputs (each contiguous), with the penalties mu_l,
    mu_o and mu_l_next as (B,) tensors on d's device, one an entry; lam is
    a host number. Returns the same tuple with (B,) tensors for the two
    sums of squares. On CUDA tensors one launch of the kernel's batched
    entry, which reads the penalties from device memory when it runs (the
    form a CUDA graph replays); each entry's stores and sums are bitwise
    those of the pointer entry launched on it alone (each entry takes the
    vector or the one-element path its own addresses allow, as that
    launch does). On CPU tensors the
    plain version, `_block_torch(..., batched=True)`."""
    nb = d.shape[0] if d.dim() else 0
    for name, m in (("mu_l", mu_l), ("mu_o", mu_o), ("mu_l_next", mu_l_next)):
        if m is not None and not (isinstance(m, torch.Tensor) and m.shape == (nb,) and m.device == d.device):
            raise ValueError(f"{name} must be a tensor of shape ({nb},) on {d.device}, one penalty an entry")
    if d.device.type == "cpu":
        got = _block_torch(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next,
                           compute_dtype=l.dtype, store_dtype=e.dtype, t_dtype=t_dtype, batched=True)
        if out is None:
            return got
        _check_out(out, (e.dtype, e.shape, d.device), None if got[6] is None else (got[6].dtype, d.shape, d.device),
                   (d, l, e, y_l, y_o))
        for buf, x in zip(out, (*got[:4], got[6])):
            if buf is not None:
                buf.copy_(x)
        return (*out[:4], got[4], got[5], out[4])
    if d.device.type == "cuda":
        return _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next, t_dtype=t_dtype, out=out, batched=True)
    raise ValueError(f"elementwise_block_batch runs on CPU or CUDA tensors, got {d.device}")


def _as_dtype(dtype) -> torch.dtype | None:
    """A dtype given as a torch dtype, a name or a numpy (or JAX) dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype if isinstance(dtype, str) else np.dtype(dtype).name)


@on_input_device("d", "l", "e", "y_l", "y_o")
def flat_elementwise_block(d, l, e, y_l, y_o, mu_l, mu_o, lam, use_pallas: bool = False, interpret: bool = False,
                           compute_dtype=None, store_dtype=None):
    """The reference's `tritd_tpu.ops.elementwise_block`
    (`tritd_tpu/ops/pallas_kernels.py:160-188`), exported as
    `tritd_tpu_torch.ops.elementwise_block`: returns (o, e_new, y_l_new,
    y_o_new, ||res_l||^2, ||res_o||^2). Computes in `compute_dtype`, or in
    the promoted dtype of the five inputs when that is None, and stores the
    four tensor outputs in `store_dtype` (default: the compute dtype); the
    two sums are in the compute dtype. `use_pallas` and `interpret` are
    accepted and have no effect, like `cfg.use_pallas`.

    On CUDA tensors it launches the hand-written kernel: in one launch when
    the inputs' dtypes name a variant (L in the compute dtype, E, Y_L, Y_O
    in the storage dtype, D in either), else the inputs cast to the compute
    dtype through the pure float32 or float64 variant and the four outputs
    rounded to `store_dtype` with `narrow_cast`: the reference's astype
    chain, bitwise. No variant computes narrower than float32, and the
    Pallas path refuses it too: such a compute dtype raises TypeError on the
    card. CPU tensors take the plain version, which computes in any float
    dtype."""
    del use_pallas, interpret
    tensors = (d, l, e, y_l, y_o)
    cd = _as_dtype(compute_dtype) or functools.reduce(torch.promote_types, (x.dtype for x in tensors))
    sd = _as_dtype(store_dtype) or cd
    if d.device.type == "cpu":
        return _block_torch(*tensors, mu_l, mu_o, lam, compute_dtype=cd, store_dtype=sd)[:6]
    if d.device.type != "cuda":
        raise ValueError(f"elementwise_block runs on CPU or CUDA tensors, got {d.device}")
    if cd not in (_F32, _F64):
        raise TypeError(f"elementwise_block computes in float32 or float64 on CUDA, got compute dtype {cd}")
    if flat_variant(*(x.dtype for x in tensors), cd, sd) is not None:
        return _block_cuda(*tensors, mu_l, mu_o, lam)[:6]
    o, e_new, y_l_new, y_o_new, nl, no, _ = _block_cuda(*(x.to(cd) for x in tensors), mu_l, mu_o, lam)
    return (*(narrow_cast(x, sd) for x in (o, e_new, y_l_new, y_o_new)), nl, no)


def flat_variant(d_dt, l_dt, e_dt, y_l_dt, y_o_dt, compute_dtype, store_dtype) -> str | None:
    """The variant `flat_elementwise_block` launches as it is on CUDA inputs
    of these dtypes (L in the compute dtype, E, Y_L, Y_O in the storage
    dtype, D in either), or None when it takes the cast route through the
    pure float32 or float64 variant."""
    if l_dt != compute_dtype or not e_dt == y_l_dt == y_o_dt == store_dtype or d_dt not in (l_dt, e_dt):
        return None
    return KERNEL_VARIANTS.get((compute_dtype, d_dt, store_dtype, store_dtype))
