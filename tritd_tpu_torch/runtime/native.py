"""ctypes binding of the host proximal library, with `ops/prox.py` fallbacks.

Counterpart of `tritd_tpu/runtime/native.py`. `capped_simplex_projection`
and `flsa` here are the exact sequential counterparts of the vectorized
operators in :mod:`tritd_tpu_torch.ops.prox`, with the contracts of the
reference's MEX kernels. They take and return float64 numpy arrays on the
host. `available()` says whether the library built (it needs g++); every
entry point falls back to `ops/prox.py` when it did not.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .build import build_host_library


@functools.cache
def _lib():
    path = build_host_library()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.capped_simplex_projection.argtypes = [dp, ctypes.c_int64, ctypes.c_double, dp]
    lib.capped_simplex_projection.restype = None
    lib.flsa.argtypes = [dp, ctypes.c_int64, ctypes.c_double, ctypes.c_double, dp]
    lib.flsa.restype = None
    lib.soft_threshold.argtypes = [dp, ctypes.c_int64, ctypes.c_double, dp]
    lib.soft_threshold.restype = None
    return lib


def available() -> bool:
    return _lib() is not None


def _as_c(v: np.ndarray):
    return v.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _torch_fallback(fn, v: np.ndarray, *args, **kwargs) -> np.ndarray:
    import torch

    return fn(torch.from_numpy(v), *args, **kwargs).numpy()


def capped_simplex_projection(v, s: float) -> np.ndarray:
    """Exact projection onto {x : 0 <= x <= 1, sum x = s}."""
    lib = _lib()
    v = np.ascontiguousarray(v, np.float64)
    if lib is None:
        from ..ops.prox import capped_simplex_projection as plain

        return _torch_fallback(plain, v, float(s))
    out = np.empty_like(v)
    lib.capped_simplex_projection(_as_c(v), v.size, float(s), _as_c(out))
    return out


def flsa(v, lam1: float, lam2: float) -> np.ndarray:
    """Exact fused-lasso signal approximator (Condat TV + l1 shrink)."""
    lib = _lib()
    v = np.ascontiguousarray(v, np.float64)
    if lib is None:
        from ..ops.prox import flsa as plain

        return _torch_fallback(plain, v, float(lam1), float(lam2), iters=2000)
    out = np.empty_like(v)
    lib.flsa(_as_c(v), v.size, float(lam1), float(lam2), _as_c(out))
    return out


def soft_threshold(v, lam: float) -> np.ndarray:
    lib = _lib()
    v = np.ascontiguousarray(v, np.float64)
    if lib is None:
        return np.sign(v) * np.maximum(np.abs(v) - lam, 0.0)
    out = np.empty_like(v)
    lib.soft_threshold(_as_c(v), v.size, float(lam), _as_c(out))
    return out
