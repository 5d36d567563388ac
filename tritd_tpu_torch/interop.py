"""Carry factors and solver state between the JAX package and this port.

`jax.random` and torch draw different numbers from the same seed, so a
parity run draws the init once (the reference's `init_factors`, or its
`init_state`), hands the arrays over as numpy, and both packages start from
the same point. This module imports no JAX: callers pass numpy arrays
(`np.asarray` of a JAX array is one).

The Tensor Toolbox surface has the same need: a Kruskal tensor
`(weights, factors)`, a Tucker tensor `(core, factors)` and a sparse tensor
`(vals, coords, shape)` go over as numpy and come back as numpy, so both
packages compute on the same numbers.

Where the arrays land follows the entry points' rule
(`ops.kruskal.on_input_device`): `device=None` is the card for numpy, as
the reference places an array on its accelerator, and raises `RuntimeError`
without CUDA; a tensor keeps its device; `device="cpu"` is the plain path.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .ops.kruskal import on_input_device
from .ops.sparse import check_coords
from .solvers.base import TriTDResult, TriTDState

_HOST_FIELDS = ("mu_l", "mu_o", "k", "done")


@on_input_device("a", "b", "c")
def factors_from_numpy(a, b, c, dtype=torch.float32):
    """(a, b, c) as numpy arrays or tensors -> tensors in `dtype`; b and c
    follow a."""
    return tuple(u.to(dtype) for u in (a, b, c))


@on_input_device("arr")
def tensor_from_numpy(arr) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype, the narrow dtypes
    included: bfloat16 and the two float8 formats are carried over bit for
    bit (`ops.kruskal.CARRIED_BITWISE`)."""
    return arr


def state_from_numpy(arrays: Mapping[str, Any], device=None) -> TriTDState:
    """A `TriTDState` from a mapping of its fields to numpy arrays, as from
    ``{f: np.asarray(getattr(s, f)) for f in s._fields}`` of the reference's
    state, on `device` (None: the card). Tensors keep their dtype;
    mu_l/mu_o become numpy scalars, k a Python int and done a 0-d device
    bool."""
    a = tensor_from_numpy(arrays["a"], device=device)
    fields = {
        f: tensor_from_numpy(arrays[f], device=a.device)
        for f in TriTDState._fields if f not in _HOST_FIELDS and f != "a"
    }
    return TriTDState(
        a=a,
        **fields,
        mu_l=np.asarray(arrays["mu_l"])[()],
        mu_o=np.asarray(arrays["mu_o"])[()],
        k=int(arrays["k"]),
        done=torch.as_tensor(bool(arrays["done"]), device=a.device),
    )


def result_to_numpy(res: TriTDResult) -> dict[str, Any]:
    """A `TriTDResult` as a dict of numpy arrays (n_iters an int)."""
    out = {
        f: getattr(res, f).detach().cpu().numpy()
        for f in TriTDResult._fields if f != "n_iters"
    }
    out["n_iters"] = int(res.n_iters)
    return out


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


@on_input_device("weights", sequences=("factors",))
def ktensor_from_numpy(weights, factors, dtype=torch.float32):
    """A Kruskal tensor `(weights, [U_1..U_N])` of numpy arrays as tensors
    in `dtype`; `weights` may be None (unit weights)."""
    w = None if weights is None else weights.to(dtype)
    return w, [u.to(dtype) for u in factors]


def ktensor_to_numpy(weights, factors):
    """`(weights, factors)` tensors as numpy arrays."""
    w = None if weights is None else _to_numpy(weights)
    return w, [_to_numpy(u) for u in factors]


@on_input_device("core", sequences=("factors",))
def ttensor_from_numpy(core, factors, dtype=torch.float32):
    """A Tucker tensor `(core, [U_1..U_N])` of numpy arrays as tensors in
    `dtype`."""
    return core.to(dtype), [u.to(dtype) for u in factors]


def ttensor_to_numpy(core, factors):
    """`(core, factors)` tensors as numpy arrays."""
    return _to_numpy(core), [_to_numpy(u) for u in factors]


def sptensor_from_numpy(vals, coords, shape, device=None, dtype=torch.float32):
    """A sparse tensor `(vals, coords, shape)` of numpy arrays as tensors in
    `dtype` (placed by the module's rule): `coords` (int32 in the reference)
    become int64. The coordinates are checked against `shape` on
    the host first (IndexError), because an out-of-range index on a CUDA
    device is an assert that poisons the context."""
    shape = tuple(int(s) for s in shape)
    check_coords(coords, shape)
    vals, coords = _sptensor_placed(vals, coords, device=device)
    return vals.to(dtype), coords.to(torch.int64), shape


@on_input_device("vals", "coords")
def _sptensor_placed(vals, coords):
    return vals, coords


def sptensor_to_numpy(vals, coords, shape):
    """`(vals, coords, shape)` as numpy arrays (coords int64) and a tuple."""
    return _to_numpy(vals), _to_numpy(coords), tuple(int(s) for s in shape)
