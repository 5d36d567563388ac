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
(default: the storage dtype). The narrow dtypes are bfloat16, float16,
float8_e4m3fn and float8_e5m2, each rounded into as `ops.narrow.narrow_cast`
rounds (the reference's `astype`). The kernel has one instantiation per
combination in `KERNEL_VARIANTS` and rejects the rest.

Routing is by device, with no fallback: CPU tensors take `_block_torch`,
CUDA tensors take `_block_cuda`, the kernel in `csrc/elementwise_block.cuh`
(its entry points in `csrc/elementwise_block*.cu`).
The scalars are host numbers; they are rounded to the compute dtype and
combined in it (lam/muO, muL+muO), as the reference does in float32.

The kernel's launch plan is made here, in plain functions of integers:
`group_size` (elements a thread takes per turn, so that the narrowest stream
moves 16 bytes), `block_grid` (one resident wave of blocks that all make the
same number of turns; a function of n alone, so the two sums are the same
from run to run) and `pointers_aligned` (16-byte accesses need every pointer
16-byte aligned; a contiguous view that is not takes the kernel's
one-element path, it is neither refused nor copied).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .narrow import narrow_cast
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
    tritd_admm produces with storage_dtype and einsum_dtype each None or one
    of the narrow dtypes: storage X unmasked (D stored in X; T' in the
    einsum dtype when one is set, else X) and masked (the imputed D in the
    compute dtype, no T'), and the einsum dtype X alone (storage in the
    compute dtype, T' in X). The C entry point is
    `tritd_elementwise_block_<variant>`."""
    table = {(_F32,) * 4: "f32", (_F64,) * 4: "f64"}
    for bits, cd in (("32", _F32), ("64", _F64)):
        for tag, x in _NARROW_TAGS.items():
            table[(cd, x, x, x)] = f"c{bits}_d{tag}_s{tag}_t{tag}"
            table[(cd, cd, x, x)] = f"c{bits}_d{bits}_s{tag}_t{tag}"
            table[(cd, cd, cd, x)] = f"c{bits}_d{bits}_s{bits}_t{tag}"
        for s_tag, s_dt in _NARROW_TAGS.items():
            for t_tag, t_dt in _NARROW_TAGS.items():
                if s_tag != t_tag:
                    table[(cd, s_dt, s_dt, t_dt)] = f"c{bits}_d{s_tag}_s{s_tag}_t{t_tag}"
    return table


KERNEL_VARIANTS = _variants()

# Launches of each variant of the hand-written kernel, counted where the
# wrapper launches it.
LAUNCHES = {f"elementwise_block[{v}]": 0 for v in KERNEL_VARIANTS.values()}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# The kernel's geometry; `_entry` holds both against the built library.
BLOCK_THREADS = 256
# One wave that an H100 SXM holds at once: 132 SMs x 2 blocks of 256 threads
# (up to 128 registers a thread: with 4 blocks and 64 registers the groups of
# 8 spilled). Fixed, not read from the card, so that the grid, and with it
# the order of the two sums, is the same on every card.
RESIDENT_BLOCKS = 132 * 2
# doubles of scratch: a partial sum of each residual per block, and the counter
SCRATCH_LEN = 2 * RESIDENT_BLOCKS + 1


def group_size(compute_size: int, narrowest_size: int) -> int:
    """Elements a thread takes per turn on the vector path: 16 bytes of the
    narrowest stream, capped at 32 bytes of the compute type (4 floats, 2
    doubles, 8 bf16 beside float compute, 4 bf16 beside double)."""
    return min(16 // narrowest_size, 32 // compute_size)


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
    variant: group_size(compute.itemsize, min(dt.itemsize for dt in stored))
    for (compute, *stored), variant in KERNEL_VARIANTS.items()
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
    """The scratch kept under `key`, made by `make()` at first use."""
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = make()
    return buf


def _scalars(dtype: torch.dtype, *values):
    """Host scalars rounded to the tensor dtype, as numpy scalars."""
    np_t = np.dtype(str(dtype).removeprefix("torch.")).type
    return tuple(None if v is None else np_t(v) for v in values)


def _block_torch(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None,
                 compute_dtype=None, store_dtype=None, t_dtype=None):
    """Plain PyTorch version: a line-for-line port of `_block_jnp`
    (`tritd_tpu/ops/pallas_kernels.py:45-66`), plus T'. compute_dtype
    defaults to d's dtype, t_dtype to the dtype the outputs are stored in.
    Stores round with `narrow_cast`, as the reference's `astype` does."""
    cd = compute_dtype or d.dtype
    mu_l, mu_o, lam, mu_l_next = _scalars(cd, mu_l, mu_o, lam, mu_l_next)
    d, l, e, y_l, y_o = (x.to(cd) for x in (d, l, e, y_l, y_o))
    r1 = d - l + y_l / float(mu_l)
    r2 = e - y_o / float(mu_o)
    o = (float(mu_l) * r1 + float(mu_o) * r2) / float(mu_l + mu_o)
    e_new = soft_threshold(o + y_o / float(mu_o), float(lam / mu_o))
    res_l = d - l - o
    res_o = o - e_new
    y_l_new = y_l + float(mu_l) * res_l
    y_o_new = y_o + float(mu_o) * res_o
    nl = torch.sum(res_l * res_l)
    no = torch.sum(res_o * res_o)
    if store_dtype is not None:
        o, e_new, y_l_new, y_o_new = (narrow_cast(x, store_dtype) for x in (o, e_new, y_l_new, y_o_new))
    t_new = None
    if mu_l_next is not None:
        # from the stored O' and Y_L', as the reference's solver reads them
        t_new = narrow_cast(d - o.to(cd) + y_l_new.to(cd) / float(mu_l_next), t_dtype or o.dtype)
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
# in none with float64, on random inputs. Truncating instead of rounding to
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
    stored O' and Y_L'; every narrow output differs from the plain one in at
    most its dtype's NARROW_FLIP_SHARE of its elements (or NARROW_FLIP_FLOOR)
    and is within one of its dtype's NARROW_ULP of it (rtol ulp, atol ulp *
    max|input|), T' within that plus what the kernel's O' and Y_L'/mu_l_next
    differ by from the plain ones; and wider outputs agree to rtol 1e-6. NaN
    in the same place on both sides counts as equal. Returns the largest
    absolute difference and the largest share of differing narrow
    elements."""
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
        ulp = NARROW_ULP.get(g.dtype)
        if ulp is not None:
            flips = int(_differ(g, w).sum())
            max_share = max(max_share, flips / g.numel())
            limit = NARROW_FLIP_SHARE[g.dtype]
            if flips > max(NARROW_FLIP_FLOOR, limit * g.numel()):
                raise AssertionError(
                    f"{names[i]}: {flips} of {g.numel()} {g.dtype} elements rounded otherwise than the plain "
                    f"version (share {flips / g.numel():.2e}, limit {limit:.1e})")
        tol = 1e-6 if ulp is None else ulp
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


def _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None, t_dtype=None):
    """Launch the variant's kernel (`csrc/elementwise_block.cuh`) on the
    current stream: one kernel. Returns the same tuple as `_block_torch`;
    the norms are 0-d views of one 2-vector on the device, so nothing waits
    for the device. The scalars are rounded to the compute dtype where they
    are passed by value."""
    tensors = (d, l, e, y_l, y_o)
    # without T' its dtype is moot: the variant with T' in the storage dtype
    t_dtype = (t_dtype or e.dtype) if mu_l_next is not None else e.dtype
    variant = kernel_variant(*tensors, t_dtype=t_dtype)
    _check_kernel_inputs(tensors)
    device = d.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next, t_dtype=t_dtype)
    fn, group, count_key = _entry(variant)
    n = d.numel()
    with_t = mu_l_next is not None
    o, e_new, y_l_new, y_o_new = outs = [torch.empty_like(e) for _ in range(4)]
    sums = torch.empty(2, dtype=l.dtype, device=device)
    pointers = [x.data_ptr() for x in (*tensors, *outs)]
    t_new = None
    if with_t:
        t_new = torch.empty_like(e) if t_dtype == e.dtype else torch.empty_like(d, dtype=t_dtype)
        pointers.append(t_new.data_ptr())
    aligned = pointers_aligned(*pointers)
    if not with_t:
        pointers.append(None)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    scratch = _scratch_for((device.index, stream), lambda: torch.zeros(SCRATCH_LEN, dtype=_F64, device=device))
    err = fn(*pointers, sums.data_ptr(), scratch.data_ptr(), n, block_grid(n, group), aligned,
             float(mu_l), float(mu_o), float(lam), float(mu_l_next) if with_t else 1.0, stream)
    if err:
        from ..runtime import kernels

        kernels.check(err, f"{count_key} launch")
    LAUNCHES[count_key] += 1
    nl, no = sums.unbind(0)
    return o, e_new, y_l_new, y_o_new, nl, no, t_new


def elementwise_block(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next=None, t_dtype=None):
    """Fused O/E/dual/residual update. Returns
    (o, e_new, y_l_new, y_o_new, ||res_l||^2, ||res_o||^2, t_new), where
    t_new = D - O' + Y_L'/mu_l_next in `t_dtype` (default: E's dtype), or
    None when mu_l_next is None. Computes in L's dtype and stores the four
    tensor outputs in E's."""
    if d.device.type == "cpu":
        return _block_torch(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next,
                            compute_dtype=l.dtype, store_dtype=e.dtype, t_dtype=t_dtype)
    if d.device.type == "cuda":
        return _block_cuda(d, l, e, y_l, y_o, mu_l, mu_o, lam, mu_l_next, t_dtype=t_dtype)
    raise ValueError(f"elementwise_block runs on CPU or CUDA tensors, got {d.device}")
