"""Mode-n matricization (unfold) and its inverse (fold) for 3-way tensors.

PyTorch counterpart of `tritd_tpu/ops/fold.py`, with the same row-major
convention ("own mode first, remaining modes (other, last)"):

    unfold(X, 1)[i, t*n2 + j] = X[i, j, t]      shape (n1, n2*n3)
    unfold(X, 2)[j, t*n1 + i] = X[i, j, t]      shape (n2, n1*n3)
    unfold(X, 3)[t, j*n1 + i] = X[i, j, t]      shape (n3, n1*n2)

Unfold columns have the LAST tensor mode major, as in the MATLAB reference
(`fast_robust_triple_tensor/unfold.m:1-14`). The three cores
A:(n1,r,r), B:(r,n2,r), C:(r,r,n3) are flattened with the (r,r) index pair
row-major (first index major):

    core_a_mat[i, p*r + q] = A[i, p, q]         shape (n1, r*r)
    core_b_mat[q*r + s, j] = B[q, j, s]         shape (r*r, n2)
    core_c_mat[q*r + s, t] = C[q, s, t]         shape (r*r, n3)

The golden literals of `tests/test_golden.py` pin both conventions.
"""

from __future__ import annotations

import torch


def unfold(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-n matricization of a 3-way tensor (mode in {1, 2, 3})."""
    n1, n2, n3 = x.shape
    if mode == 1:
        return x.permute(0, 2, 1).reshape(n1, n3 * n2)
    if mode == 2:
        return x.permute(1, 2, 0).reshape(n2, n3 * n1)
    if mode == 3:
        return x.permute(2, 1, 0).reshape(n3, n2 * n1)
    raise ValueError(f"mode must be 1, 2 or 3, got {mode}")


def fold(xn: torch.Tensor, mode: int, shape: tuple[int, int, int]) -> torch.Tensor:
    """Inverse of :func:`unfold`: ``fold(unfold(x, m), m, x.shape) == x``."""
    n1, n2, n3 = shape
    if mode == 1:
        return xn.reshape(n1, n3, n2).permute(0, 2, 1)
    if mode == 2:
        return xn.reshape(n2, n3, n1).permute(2, 0, 1)
    if mode == 3:
        return xn.reshape(n3, n2, n1).permute(2, 1, 0)
    raise ValueError(f"mode must be 1, 2 or 3, got {mode}")


def core_a_mat(a: torch.Tensor) -> torch.Tensor:
    """A:(n1,r,r) -> (n1, r*r) with columns (p, q) row-major."""
    n1, r, _ = a.shape
    return a.reshape(n1, r * r)


def core_a_from_mat(a1: torch.Tensor, r: int) -> torch.Tensor:
    """(n1, r*r) -> A:(n1,r,r). Inverse of :func:`core_a_mat`."""
    return a1.reshape(a1.shape[0], r, r)


def core_b_mat(b: torch.Tensor) -> torch.Tensor:
    """B:(r,n2,r) -> (r*r, n2) with rows (q, s) row-major."""
    r, n2, _ = b.shape
    return b.permute(0, 2, 1).reshape(r * r, n2)


def core_b_from_mat(b2: torch.Tensor, r: int) -> torch.Tensor:
    """(n2, r*r) row-per-j layout -> B:(r,n2,r). Used after the mode-2 solve,
    where row j holds vec(B[:, j, :]); note the transpose."""
    return b2.reshape(b2.shape[0], r, r).permute(1, 0, 2)


def core_c_mat(c: torch.Tensor) -> torch.Tensor:
    """C:(r,r,n3) -> (r*r, n3) with rows (q, s) row-major."""
    r, _, n3 = c.shape
    return c.reshape(r * r, n3)


def core_c_from_mat(c3: torch.Tensor, r: int) -> torch.Tensor:
    """(n3, r*r) row-per-t layout -> C:(r,r,n3). Used after the mode-3 solve,
    where row t holds vec(C[:, :, t])."""
    return c3.reshape(c3.shape[0], r, r).permute(1, 2, 0)
