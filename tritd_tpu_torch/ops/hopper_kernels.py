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
(default: the storage dtype). The kernel has one instantiation per
combination in `KERNEL_VARIANTS` and rejects the rest.

Routing is by device, with no fallback: CPU tensors take `_block_torch`,
CUDA tensors take `_block_cuda`, the kernel in `csrc/elementwise_block.cu`.
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

from .shrinkage import soft_threshold

_F32, _F64, _BF16 = torch.float32, torch.float64, torch.bfloat16

# (compute, D, storage, T') -> variant; the C entry point is
# `tritd_elementwise_block_<variant>`. The narrow rows are the combinations
# tritd_admm produces: storage_dtype="bfloat16" unmasked (D stored narrow)
# and masked (the imputed D is in the compute dtype, no T'), and
# einsum_dtype="bfloat16" alone (storage in the compute dtype, T' narrow).
KERNEL_VARIANTS = {
    (_F32, _F32, _F32, _F32): "f32",
    (_F64, _F64, _F64, _F64): "f64",
    (_F32, _BF16, _BF16, _BF16): "c32_dbf16_sbf16_tbf16",
    (_F64, _BF16, _BF16, _BF16): "c64_dbf16_sbf16_tbf16",
    (_F32, _F32, _BF16, _BF16): "c32_d32_sbf16_tbf16",
    (_F64, _F64, _BF16, _BF16): "c64_d64_sbf16_tbf16",
    (_F32, _F32, _F32, _BF16): "c32_d32_s32_tbf16",
    (_F64, _F64, _F64, _BF16): "c64_d64_s64_tbf16",
}

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
    defaults to d's dtype, t_dtype to the dtype the outputs are stored in."""
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
        o, e_new, y_l_new, y_o_new = (x.to(store_dtype) for x in (o, e_new, y_l_new, y_o_new))
    t_new = None
    if mu_l_next is not None:
        # from the stored O' and Y_L', as the reference's solver reads them
        t_new = (d - o.to(cd) + y_l_new.to(cd) / float(mu_l_next)).to(t_dtype or o.dtype)
    return o, e_new, y_l_new, y_o_new, nl, no, t_new


BF16_ULP = 2.0**-8
# Largest share of a bf16 output whose rounding may differ from the plain
# version's. An ulp of difference in the compute dtype (FMA contraction,
# PyTorch's CUDA division by a host scalar through its reciprocal) flips a
# bf16 rounding in up to 7.4e-5 of an output's elements with float32
# compute on an H100 (most in Y_O', where O' - E' cancels) and in none with
# float64, on random inputs. Truncating instead of rounding to nearest even flips
# 24-50% of them, and T' from the unrounded O' and Y_L' 36%. Small tensors
# may flip NARROW_FLIP_FLOOR elements whatever their size.
NARROW_FLIP_SHARE = 3e-4
NARROW_FLIP_FLOOR = 4


def check_narrow_against_plain(args, got, want, mu_l_next=None) -> dict:
    """Hold a narrow kernel variant's outputs `got` against the plain
    version's `want` (both tuples as `_block_torch` returns them, from the
    five inputs `args`). Raises AssertionError unless T' is bitwise the
    rounding of D - O' + Y_L'/mu_l_next computed from the kernel's own
    stored O' and Y_L'; every bf16 output differs from the plain one in at
    most NARROW_FLIP_SHARE of its elements (or NARROW_FLIP_FLOOR) and is
    within one bf16 ulp of it (rtol 2**-8, atol 2**-8 * max|input|); and
    wider outputs agree to rtol 1e-6. Returns the largest absolute
    difference and the largest share of differing bf16 elements."""
    d, cd = args[0], args[1].dtype
    scale = max(float(a.abs().max()) for a in args)
    idx = (0, 1, 2, 3) if mu_l_next is None else (0, 1, 2, 3, 6)
    names = ("o", "e", "y_l", "y_o", "nl", "no", "t")
    if mu_l_next is not None:
        mu = torch.tensor(mu_l_next, dtype=cd, device=d.device)  # true division, also on CUDA
        rebuilt = (d.to(cd) - got[0].to(cd) + got[2].to(cd) / mu).to(got[6].dtype)
        wrong = int((rebuilt != got[6]).sum())
        if wrong:
            raise AssertionError(f"t: {wrong} of {rebuilt.numel()} elements are not D - O' + Y_L'/mu_l_next "
                                 f"from the stored O' and Y_L'")
    max_abs, max_share = 0.0, 0.0
    for i in idx:
        g, w = got[i], want[i]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{names[i]}: {g.dtype}{tuple(g.shape)} vs plain {w.dtype}{tuple(w.shape)}")
        max_abs = max(max_abs, float((g.to(cd) - w.to(cd)).abs().max()))
        if g.dtype == _BF16:
            flips = int((g != w).sum())
            max_share = max(max_share, flips / g.numel())
            if flips > max(NARROW_FLIP_FLOOR, NARROW_FLIP_SHARE * g.numel()):
                raise AssertionError(
                    f"{names[i]}: {flips} of {g.numel()} bf16 elements rounded otherwise than the plain "
                    f"version (share {flips / g.numel():.2e}, limit {NARROW_FLIP_SHARE:.0e})")
        tol = BF16_ULP if g.dtype == _BF16 else 1e-6
        torch.testing.assert_close(g.to(cd), w.to(cd), rtol=tol, atol=tol * scale,
                                   msg=lambda m, n=names[i]: f"{n}: {m}")
    return {"max_abs_err": max_abs, "flip_share": max_share}


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
    """Launch `csrc/elementwise_block.cu` on the current stream: one kernel.
    Returns the same tuple as `_block_torch`; the norms are 0-d views of one
    2-vector on the device, so nothing waits for the device. The scalars are
    rounded to the compute dtype where they are passed by value."""
    tensors = (d, l, e, y_l, y_o)
    t_dtype = t_dtype or e.dtype
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
