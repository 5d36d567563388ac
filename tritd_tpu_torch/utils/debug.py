"""Numerical-debugging helpers.

PyTorch counterpart of `tritd_tpu/utils/debug.py`. The reference switches
JAX's debug modes; these switch PyTorch's: anomaly detection for NaNs in a
backward pass, deterministic algorithms with TF32 off for runs that must
repeat bit for bit, and a host-side finiteness check.
"""

from __future__ import annotations

import contextlib

import torch

from .timing import iter_tensors


@contextlib.contextmanager
def nan_debug():
    """Trap NaNs where autograd produces them (`torch.autograd.
    detect_anomaly`, which records a traceback per op: for diagnosis only).
    The solvers here take no gradients; for them `check_finite` on the
    state between iterations says where a NaN first appears."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


@contextlib.contextmanager
def strict_determinism():
    """Bitwise-repeatable mode: `torch.use_deterministic_algorithms(True)`
    (an op without a deterministic kernel raises) and TF32 off for matmuls
    and convolutions; restored on exit. On CUDA, cuBLAS also wants
    `CUBLAS_WORKSPACE_CONFIG=:4096:8` in the environment."""
    prev = (torch.are_deterministic_algorithms_enabled(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]
        torch.backends.cudnn.allow_tf32 = prev[2]


def check_finite(tree, where: str = "") -> None:
    """Raise FloatingPointError unless every tensor of the nest is finite
    (one device-to-host read per tensor)."""
    for i, leaf in enumerate(iter_tensors(tree)):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in leaf {i}" + (f" at {where}" if where else ""))
