"""Carry factors and solver state between the JAX package and this port.

`jax.random` and torch draw different numbers from the same seed, so a
parity run draws the init once (the reference's `init_factors`, or its
`init_state`), hands the arrays over as numpy, and both packages start from
the same point. This module imports no JAX: callers pass numpy arrays
(`np.asarray` of a JAX array is one).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

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


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor of the same dtype, bfloat16 included (numpy
    holds it as the `ml_dtypes` extension type, which torch cannot read:
    its bits are carried over as int16)."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
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
