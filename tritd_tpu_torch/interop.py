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
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .ops.sparse import check_coords
from .solvers.base import TriTDResult, TriTDState

_HOST_FIELDS = ("mu_l", "mu_o", "k", "done")


def factors_from_numpy(a, b, c, device="cpu", dtype=torch.float32):
    """(a, b, c) as numpy arrays or tensors -> tensors on `device` in `dtype`."""
    return tuple(
        torch.as_tensor(u if isinstance(u, torch.Tensor) else np.array(u)).to(
            device=device, dtype=dtype
        )
        for u in (a, b, c)
    )


# The narrow dtypes numpy holds as `ml_dtypes` extension types, which torch
# cannot read: by name, the integer type their bits are carried in. float16
# is native to numpy.
_CARRIED_BITWISE = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor of the same dtype, the narrow dtypes
    included: bfloat16 and the two float8 formats are recognised by their
    dtype's name (no `ml_dtypes` import) and carried over bit for bit."""
    arr = np.array(arr)
    carried = _CARRIED_BITWISE.get(arr.dtype.name)
    if carried is not None:
        bits, dtype = carried
        return torch.from_numpy(arr.view(bits)).view(dtype).to(device)
    return torch.as_tensor(arr, device=device)


def state_from_numpy(arrays: Mapping[str, Any], device="cpu") -> TriTDState:
    """A `TriTDState` from a mapping of its fields to numpy arrays, as from
    ``{f: np.asarray(getattr(s, f)) for f in s._fields}`` of the reference's
    state. Tensors keep their dtype; mu_l/mu_o become numpy scalars, k a
    Python int and done a 0-d device bool."""
    fields = {
        f: tensor_from_numpy(arrays[f], device=device)
        for f in TriTDState._fields if f not in _HOST_FIELDS
    }
    return TriTDState(
        **fields,
        mu_l=np.asarray(arrays["mu_l"])[()],
        mu_o=np.asarray(arrays["mu_o"])[()],
        k=int(arrays["k"]),
        done=torch.as_tensor(bool(arrays["done"]), device=device),
    )


def result_to_numpy(res: TriTDResult) -> dict[str, Any]:
    """A `TriTDResult` as a dict of numpy arrays (n_iters an int)."""
    out = {
        f: getattr(res, f).detach().cpu().numpy()
        for f in TriTDResult._fields if f != "n_iters"
    }
    out["n_iters"] = int(res.n_iters)
    return out


def _to_tensor(arr, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(arr)).to(device=device, dtype=dtype)


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def ktensor_from_numpy(weights, factors, device="cpu", dtype=torch.float32):
    """A Kruskal tensor `(weights, [U_1..U_N])` of numpy arrays as tensors
    on `device` in `dtype`; `weights` may be None (unit weights)."""
    w = None if weights is None else _to_tensor(weights, device, dtype)
    return w, [_to_tensor(u, device, dtype) for u in factors]


def ktensor_to_numpy(weights, factors):
    """`(weights, factors)` tensors as numpy arrays."""
    w = None if weights is None else _to_numpy(weights)
    return w, [_to_numpy(u) for u in factors]


def ttensor_from_numpy(core, factors, device="cpu", dtype=torch.float32):
    """A Tucker tensor `(core, [U_1..U_N])` of numpy arrays as tensors."""
    return _to_tensor(core, device, dtype), [_to_tensor(u, device, dtype) for u in factors]


def ttensor_to_numpy(core, factors):
    """`(core, factors)` tensors as numpy arrays."""
    return _to_numpy(core), [_to_numpy(u) for u in factors]


def sptensor_from_numpy(vals, coords, shape, device="cpu", dtype=torch.float32):
    """A sparse tensor `(vals, coords, shape)` of numpy arrays as tensors:
    `coords` (int32 in the reference) become int64. The coordinates are
    checked against `shape` on the host first (IndexError), because an
    out-of-range index on a CUDA device is an assert that poisons the
    context."""
    shape = tuple(int(s) for s in shape)
    coords = np.array(coords)
    check_coords(coords, shape)
    return (
        _to_tensor(vals, device, dtype),
        torch.as_tensor(coords.astype(np.int64), device=device),
        shape,
    )


def sptensor_to_numpy(vals, coords, shape):
    """`(vals, coords, shape)` as numpy arrays (coords int64) and a tuple."""
    return _to_numpy(vals), _to_numpy(coords), tuple(int(s) for s in shape)
