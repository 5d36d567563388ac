"""Sparse (COO) tensor operations — the Tensor Toolbox ``@sptensor`` /
``@sptenmat`` class surface.

PyTorch counterpart of `tritd_tpu/ops/sparse.py`. A sparse tensor is the
functional triple ``(vals, coords, shape)`` with ``vals: (nnz,)`` and
``coords: (nnz, N)`` int64 (the reference's are int32; `index_add_` and
gathers want int64). There is no class; functions take/return the triple.

Zero-entries convention: duplicate coordinates accumulate (MATLAB sptensor
constructor sums duplicates); explicit zeros are allowed and harmless.

Out-of-range coordinates are a caller error. The reference clamps or drops
them silently; here a gather or `index_add_` with such an index raises on
the CPU (IndexError/RuntimeError) and is a device-side assert on CUDA, which
poisons the CUDA context for the rest of the process. So the constructors
that generate coordinates (`sptenrand`, `sptendiag`) guarantee validity, and
`check_coords` (used by `interop.sptensor_from_numpy`) validates
caller-made coordinates on the host before they reach a device.

Scatter-adds are `index_add_`: on CUDA it adds atomically, so float32 sums
differ from run to run in the last digits, and `cp_als_sparse`'s `n_iters`
at `tol > 0` may differ by one from a CPU run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .decomp import _hadamard_gram, _scalar, _spd_solve_rows
from .kruskal import cp_normalize, default_device, default_generator, draw


def check_coords(coords, shape) -> None:
    """Raise IndexError unless every row of `coords` (numpy array or CPU
    tensor, (nnz, N)) indexes into `shape`. Host-side: call it before the
    coordinates go to a device."""
    arr = coords.detach().cpu().numpy() if isinstance(coords, torch.Tensor) else np.asarray(coords)
    shape = tuple(int(s) for s in shape)
    if arr.ndim != 2 or arr.shape[1] != len(shape):
        raise ValueError(f"coords must be (nnz, {len(shape)}), got {arr.shape}")
    if arr.size and (arr.min() < 0 or (arr >= np.asarray(shape)[None, :]).any()):
        raise IndexError(f"coordinate out of range for shape {shape}")


def _numel(shape) -> int:
    total = 1
    for s in shape:
        total *= int(s)
    return total


def sp_full(vals: torch.Tensor, coords: torch.Tensor, shape) -> torch.Tensor:
    """Dense tensor from COO — ``full(sptensor)``. Duplicates accumulate."""
    shape = tuple(int(s) for s in shape)
    flat_idx = sp_sub2ind(coords, shape)
    out = torch.zeros((_numel(shape),), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, flat_idx, vals)
    return out.reshape(shape)


def sp_sub2ind(coords: torch.Tensor, shape) -> torch.Tensor:
    """Row-major linear indices from (nnz, N) subscripts — ``tt_sub2ind``
    semantics under this framework's row-major convention (the MATLAB
    original is column-major; the convention is documented once in
    ops/fold.py and applied uniformly)."""
    shape = tuple(int(s) for s in shape)
    strides = []
    acc = 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    strides = torch.tensor(strides[::-1], dtype=coords.dtype, device=coords.device)
    return (coords * strides[None, :]).sum(dim=1)


def sp_ind2sub(idx: torch.Tensor, shape) -> torch.Tensor:
    """(nnz, N) subscripts from row-major linear indices — ``tt_ind2sub``."""
    shape = tuple(int(s) for s in shape)
    subs = []
    rem = idx
    for s in reversed(shape):
        subs.append(rem % s)
        rem = torch.div(rem, s, rounding_mode="floor")
    return torch.stack(subs[::-1], dim=1)


def sptenrand(generator, shape, nnz: int, dtype=torch.float32, device=None):
    """Random sparse tensor — ``sptenrand(sz, nnz)``: `nnz` uniform values at
    uniform coordinates (collisions accumulate, as the MATLAB constructor
    sums duplicate subscripts). Returns ``(vals, coords, shape)``; the
    coordinates are valid by construction."""
    generator = default_generator(generator)
    device = default_device(device)
    shape = tuple(int(s) for s in shape)
    flat = torch.randint(
        0, _numel(shape), (nnz,), generator=generator, dtype=torch.int64,
        device=generator.device,
    ).to(device)
    coords = sp_ind2sub(flat, shape)
    vals = draw("uniform", generator, (nnz,), dtype, device)
    return vals, coords, shape


def sptendiag(v: torch.Tensor, shape=None):
    """Sparse tensor with `v` on the superdiagonal — ``sptendiag(v, sz)``."""
    n = int(v.shape[0])
    if shape is None:
        shape = (n, n, n)
    shape = tuple(int(s) for s in shape)
    if n > min(shape):
        raise IndexError(f"{n} diagonal entries do not fit in shape {shape}")
    idx = torch.arange(n, dtype=torch.int64, device=v.device)
    coords = torch.stack([idx] * len(shape), dim=1)
    return v, coords, shape


def sp_norm(vals: torch.Tensor, coords: torch.Tensor, shape) -> torch.Tensor:
    """Frobenius norm — ``norm(sptensor)``. Correct even with duplicate
    coordinates (they must be summed before squaring)."""
    if _numel(shape) <= 4 * vals.shape[0]:
        return torch.linalg.vector_norm(sp_full(vals, coords, shape))
    # segment-sum duplicates over the touched slots only: sort by index (any
    # order within a run of equal indices will do), add within equal runs.
    flat_idx = sp_sub2ind(coords, shape)
    order = torch.argsort(flat_idx)
    si, sv = flat_idx[order], vals[order]
    # ownership: each run of equal indices collapses onto its first slot
    starts = torch.cat([
        torch.zeros((1,), dtype=torch.int64, device=si.device),
        (si[1:] != si[:-1]).to(torch.int64),
    ])
    seg = torch.cumsum(starts, dim=0)
    summed = torch.zeros_like(sv).index_add_(0, seg, sv)
    return torch.linalg.vector_norm(summed)


def sp_innerprod(vals, coords, shape, dense: torch.Tensor) -> torch.Tensor:
    """<sparse, dense> — ``innerprod(sptensor, tensor)``: gather + dot,
    O(nnz) instead of densifying."""
    flat_idx = sp_sub2ind(coords, shape)
    return torch.dot(vals, dense.reshape(-1)[flat_idx])


def sp_ttv(vals, coords, shape, vecs, modes) -> torch.Tensor:
    """Sparse tensor times vector(s) in the given modes — ``ttv(sptensor,
    v, n)``: scale each nonzero by the gathered vector entries, then
    scatter-add over the contracted modes. Returns a DENSE tensor on the
    remaining modes (matching ``full(ttv(...))``)."""
    modes = tuple(int(m) for m in modes)
    scaled = vals
    for v, m in zip(vecs, modes):
        scaled = scaled * v[coords[:, m]]
    keep = [ax for ax in range(len(shape)) if ax not in modes]
    if not keep:
        return scaled.sum()
    out_shape = tuple(int(shape[ax]) for ax in keep)
    return sp_full(scaled, coords[:, keep], out_shape)


def sp_mttkrp(vals, coords, shape, factors, mode: int) -> torch.Tensor:
    """Sparse MTTKRP — ``mttkrp(sptensor, U, n)``: for each nonzero, the
    Hadamard product of the other modes' factor rows, scatter-added into the
    mode's rows. O(nnz * R) operations and memory traffic; never
    materializes the Khatri-Rao product or the dense tensor. This is what
    sparse CP-ALS is built on."""
    n = len(shape)
    r = factors[0].shape[1]
    rows = vals[:, None].expand(-1, r)
    for ax in range(n):
        if ax == mode:
            continue
        rows = rows * factors[ax][coords[:, ax]]
    out = torch.zeros((int(shape[mode]), r), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, coords[:, mode], rows)


def sptenmat(vals, coords, shape, row_modes, col_modes=None):
    """Sparse matricization — ``sptenmat``: returns COO matrix
    ``(vals, (row_idx, col_idx), (n_rows, n_cols))`` with the same
    row-major flattening convention as `ops/kruskal.py`'s `tenmat`."""
    n = len(shape)
    row_modes = tuple(int(m) for m in row_modes)
    if col_modes is None:
        col_modes = tuple(m for m in range(n) if m not in row_modes)
    else:
        col_modes = tuple(int(m) for m in col_modes)
    row_shape = tuple(int(shape[m]) for m in row_modes)
    col_shape = tuple(int(shape[m]) for m in col_modes)
    ridx = sp_sub2ind(coords[:, list(row_modes)], row_shape)
    cidx = (
        sp_sub2ind(coords[:, list(col_modes)], col_shape)
        if col_modes
        else torch.zeros_like(ridx)
    )
    return vals, (ridx, cidx), (_numel(row_shape), _numel(col_shape))


def sp_elemwise(vals, coords, shape, fn) -> tuple:
    """Apply an elementwise function that maps 0 -> 0 to the nonzeros —
    the sptensor arithmetic surface (``times``, ``abs``, ``power`` etc.)
    collapsed to its one sound primitive."""
    return fn(vals), coords, shape


def cp_als_sparse(
    vals,
    coords,
    shape,
    rank: int,
    max_iters: int = 50,
    tol: float = 1e-4,
    generator=None,
    init_factors=None,
):
    """CP-ALS on a sparse tensor — ``cp_als(sptensor, R)``: identical update
    equations to the dense path (``cp_als.m``; see `ops/decomp.py`'s
    `cp_als`) with the MTTKRP swapped for the O(nnz·R) sparse one and the
    fit computed from nnz-local quantities (<X, M> via gathered model rows)
    — the dense tensor never materializes, so memory is O(nnz·R + Σnᵢ·R)."""
    if init_factors is None:
        generator = default_generator(generator)
        init_factors = [
            draw("uniform", generator, (s, rank), vals.dtype, vals.device) for s in shape
        ]
    n = len(shape)
    # duplicate-aware ||X||: duplicate coordinates accumulate (module
    # convention, and sptenrand produces them), so ||vals||_2 would be wrong.
    norm_x = sp_norm(vals, coords, shape)

    def model_at_nonzeros(factors):
        rows = factors[0][coords[:, 0]]
        for ax in range(1, n):
            rows = rows * factors[ax][coords[:, ax]]
        return rows.sum(dim=1)

    factors = list(init_factors)
    fit = _scalar(-math.inf, vals)
    delta, it = math.inf, 0
    while it < max_iters and delta >= tol:
        for mode in range(n):
            rhs = sp_mttkrp(vals, coords, shape, factors, mode)
            factors[mode] = _spd_solve_rows(_hadamard_gram(factors, mode), rhs)
        inner = torch.dot(vals, model_at_nonzeros(factors))
        resid_sq = torch.clamp(
            norm_x**2 + _hadamard_gram(factors).sum() - 2.0 * inner, min=0.0
        )
        new_fit = 1.0 - torch.sqrt(resid_sq) / norm_x
        delta = float(torch.abs(new_fit - fit))
        fit = new_fit
        it += 1
    factors, weights = cp_normalize(factors)
    return {"weights": weights, "factors": factors, "fit": fit, "n_iters": it}
