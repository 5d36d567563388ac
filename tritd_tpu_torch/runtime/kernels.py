"""ctypes binding of the library built by :mod:`tritd_tpu_torch.runtime.build`.

Every pointer and the stream are passed as `c_void_p`, sizes as `c_int64`,
scalars by value in the compute type, or, in a variant's pointer entry
(`..._ptr`), the three penalties as addresses of values in device memory;
its batched entry (`..._batch`) takes the entry count after n and the
penalties as addresses of arrays of one value an entry. SOFIA's kernels
(`csrc/sofia_kernels.cu`, :mod:`tritd_tpu_torch.ops.sofia_kernels`) take
their counts as `c_int64`, the rank as `c_int` and their scalars by value;
the cuSOLVER entries of `csrc/device_linalg.cu` and the Jacobi SVD's of
`csrc/jacobi_svd.cu` (:mod:`tritd_tpu_torch.ops.device_linalg`) are
declared by `_bind_linalg` and `_bind_jacobi`.
Loading the library builds it, so the first CUDA call pays the nvcc
compile; importing this module does not.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.hopper_kernels import KERNEL_VARIANTS
from . import build

_P = ctypes.c_void_p

# The compute type of a kernel variant, which its scalars are passed in.
_SCALAR_TYPES = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def _block_argtypes(scalar, pointer: bool, batch: bool = False):
    # d, l, e, y_l, y_o, o, e', y_l', y_o', t', sums, scratch; n; blocks,
    # aligned (the batched entry: n_batch, blocks); mu_l, mu_o, lam,
    # mu_l_next (the pointer and batched entries: addresses of mu_l, mu_o
    # and mu_l_next); stream
    head = [_P] * 12 + [ctypes.c_int64] + [ctypes.c_int] * 2
    return head + ([_P, _P, scalar, _P] if pointer or batch else [scalar] * 4) + [_P]


def bind(path, variants=None) -> ctypes.CDLL:
    """Load a library built from `csrc/*.cu` and declare its entry points:
    those of `variants` (names of KERNEL_VARIANTS), by default every one."""
    lib = ctypes.CDLL(str(path))
    for name in ("tritd_max_blocks", "tritd_block_threads", "tritd_scratch_len"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.tritd_error_string.argtypes = [ctypes.c_int]
    lib.tritd_error_string.restype = ctypes.c_char_p
    for name in ("tritd_quotient_check_f32", "tritd_quotient_check_f64"):
        if hasattr(lib, name):  # not in a library built from an earlier revision
            # ys, ny, first, count, counts, stream
            getattr(lib, name).argtypes = [_P, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, _P, _P]
            getattr(lib, name).restype = ctypes.c_int
    for (compute, *_), variant in KERNEL_VARIANTS.items():
        if variants is not None and variant not in variants:
            continue
        name = f"tritd_elementwise_block_{variant}"
        for suffix in ("", "_ptr", "_batch"):
            if suffix and not hasattr(lib, name + suffix):  # not in a library built from an earlier revision
                continue
            fn = getattr(lib, name + suffix)
            fn.argtypes = _block_argtypes(_SCALAR_TYPES[compute], pointer=suffix == "_ptr", batch=suffix == "_batch")
            fn.restype = ctypes.c_int
        group = getattr(lib, f"tritd_elementwise_block_{variant}_group")
        group.argtypes = []
        group.restype = ctypes.c_int
    if hasattr(lib, "tritd_sofia_max_rank"):  # not in a library built from an earlier revision
        lib.tritd_sofia_max_rank.argtypes = []
        lib.tritd_sofia_max_rank.restype = ctypes.c_int
        for tag, scalar in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            # rhs, gram, out, n, r, rtol, stream
            getattr(lib, f"tritd_pinv_rows_{tag}").argtypes = [_P, _P, _P, ctypes.c_int64, ctypes.c_int, scalar, _P]
            # rhs0, inv, out, n3, r, lam1, lam2, m, stream
            getattr(lib, f"tritd_gauss_seidel_sweep_{tag}").argtypes = [
                _P, _P, _P, ctypes.c_int64, ctypes.c_int, scalar, scalar, ctypes.c_int64, _P]
            for name in ("pinv_rows", "gauss_seidel_sweep"):
                getattr(lib, f"tritd_{name}_{tag}").restype = ctypes.c_int
            if hasattr(lib, f"tritd_mode3_sweep_{tag}"):  # not in a library built from an earlier revision
                # u3, rhs_base, gram_base, out, n3, r, lam1, lam2, m, stream
                fn = getattr(lib, f"tritd_mode3_sweep_{tag}")
                fn.argtypes = [_P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, scalar, scalar, ctypes.c_int64, _P]
                fn.restype = ctypes.c_int
    if hasattr(lib, "tritd_linalg_create"):  # not in a library built from an earlier revision
        _bind_linalg(lib)
    if hasattr(lib, "tritd_jacobi_block"):  # not in a library built from an earlier revision
        _bind_jacobi(lib)
    return lib


def _bind_jacobi(lib: ctypes.CDLL) -> None:
    """The Jacobi SVD's entry points of `csrc/jacobi_svd.cu`: pointers and
    the stream `c_void_p`, sizes `c_int64`, the plan's counts `c_int`, the
    tolerance, floor and negligible fraction `c_double`; each launcher returns `cudaGetLastError()` (or
    `cudaErrorInvalidValue` for a plan it does not take), the occupancy
    query a count or minus the error."""
    i64, i32 = ctypes.c_int64, ctypes.c_int
    for name in ("tritd_jacobi_block", "tritd_jacobi_tile", "tritd_jacobi_sweeps"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.tritd_jacobi_fixed_smem.argtypes = [i32]  # f64
    lib.tritd_jacobi_fixed_smem.restype = i32
    lib.tritd_jacobi_active_clusters.argtypes = [i32, i32, i32]  # f64, cluster, smem
    lib.tritd_jacobi_active_clusters.restype = i32
    lib.tritd_jacobi_launches.argtypes = [_P]  # out
    lib.tritd_jacobi_launches.restype = i32
    if hasattr(lib, "tritd_jacobi_phase_cycles"):  # a build with -DTRITD_JACOBI_TRACE (tools/jacobi_phases)
        lib.tritd_jacobi_phase_cycles.argtypes = [_P]  # out
        lib.tritd_jacobi_phase_cycles.restype = i32
    for tag in ("f32", "f64"):
        fn = getattr(lib, f"tritd_jacobi_svd_{tag}")
        # a, p, q, wt, ldw, vt, ldv, state, capped, gsum, refs, sig, s, wn, vs, nb, cluster, team, clusters,
        # chunk, stages, smem, sweeps, tol, rounding, negligible, stream
        fn.argtypes = [_P, i64, i64, _P, i64, _P, i64, _P, _P, _P, _P, _P, _P, _P, _P, i32, i32, i32, i32, i32, i32,
                       i32, i32] + [ctypes.c_double] * 3 + [_P]
        fn.restype = i32


def _bind_linalg(lib: ctypes.CDLL) -> None:
    """The cuSOLVER entry points of `csrc/device_linalg.cu`: handles and
    pointers `c_void_p`, the dtype code `c_int`, the 64-bit API's sizes
    `c_int64` and workspace bytes `c_size_t`, gesvdj's sizes and lwork
    `c_int`; each returns cuSOLVER's status."""
    i64, i32, size, out_size, out_int = (ctypes.c_int64, ctypes.c_int, ctypes.c_size_t,
                                         ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int))
    argtypes = {
        "tritd_linalg_version": [],
        "tritd_linalg_provider": [ctypes.c_char_p, i32],
        "tritd_linalg_create": [ctypes.POINTER(_P), ctypes.POINTER(_P)],
        "tritd_gesvdj_info_create": [ctypes.POINTER(_P), ctypes.c_double, i32],
        # handle, params, dt, n, a, w, dev bytes, host bytes
        "tritd_xsyevd_buffer": [_P, _P, i32, i64, _P, _P, out_size, out_size],
        # handle, params, dt, n, a, w, work, dev bytes, host work, host bytes, info, stream
        "tritd_xsyevd": [_P, _P, i32, i64, _P, _P, _P, size, _P, size, _P, _P],
        "tritd_xsyevbatched_buffer": [_P, _P, i32, i64, _P, _P, out_size, out_size],
        "tritd_xsyevbatched": [_P, _P, i32, i64, _P, _P, _P, size, _P, size, _P, _P],
        # handle, gesvdj info, dt, m, n, a, s, u, v, lwork
        "tritd_gesvdj_buffer": [_P, _P, i32, i32, i32, _P, _P, _P, _P, out_int],
        # handle, gesvdj info, dt, m, n, a, s, u, v, work, lwork, info, stream
        "tritd_gesvdj": [_P, _P, i32, i32, i32, _P, _P, _P, _P, _P, i32, _P, _P],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    return bind(build.build())


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().tritd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
