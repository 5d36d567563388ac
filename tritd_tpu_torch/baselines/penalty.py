"""The geometric penalty schedules of the baseline ADMMs."""

from __future__ import annotations

import numpy as np
import torch


def host_scalar_type(dtype: torch.dtype) -> type:
    """The numpy scalar type of a torch dtype, for host arithmetic that must
    round as the device's does."""
    return np.dtype(str(dtype).removeprefix("torch.")).type


def grown_penalty(base: float, rate: float, k: int, dtype: torch.dtype, cap: float | None = None) -> float:
    """base * rate**k (at most `cap`), computed on the host in the run's
    dtype, as the reference computes it in the array dtype inside its traced
    loop: at float32 a penalty computed in double would differ in the last
    bit and the trajectories with it."""
    dt = host_scalar_type(dtype)
    value = dt(base) * dt(rate) ** k
    if cap is not None:
        value = min(value, dt(cap))
    return float(value)
