"""ctypes binding of the library built by :mod:`tritd_tpu_torch.runtime.build`.

Every pointer and the stream are passed as `c_void_p`, sizes as `c_int64`,
scalars by value in the compute type, or, in a variant's pointer entry
(`..._ptr`), the three penalties as addresses of values in device memory;
its batched entry (`..._batch`) takes the entry count after n and the
penalties as addresses of arrays of one value an entry.
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
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    return bind(build.build())


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().tritd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
