"""Checkpoint/resume of ADMM solver state.

PyTorch counterpart of `tritd_tpu/utils/checkpoint.py`, with the same `.npz`
layout and field names: one array per `TriTDState` field, mu_l/mu_o 0-d in
the solver dtype, k 0-d int32, done 0-d bool; bfloat16 and the two float8
types are widened to float32 (exact) on save, float16 is saved as it is
(numpy's own). `load_state` narrows them again with `narrow_cast`, so a
resume is bitwise. A checkpoint in float32, float64, float16 or bfloat16
written by either package loads in the other. The reference cannot save
float8: its `_np_savable` reads an e4m3fn array as raw bytes and halves its
last axis, and saves e5m2 as a type `np.load` cannot rebuild (an open fault
of the reference, ROADMAP.md section 3). The reference's Orbax backend is a
JAX library and is not ported: `use_orbax=True` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.narrow import FLOAT8, narrow_cast
from ..solvers.base import TriTDState

_FIELDS = TriTDState._fields
_HOST_FIELDS = ("mu_l", "mu_o", "k", "done")


def _np_savable(x) -> np.ndarray:
    """A field as numpy; bf16 and float8 tensors widened to float32, which is
    exact and what `np.load` can read back (load_state narrows them again)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, *FLOAT8):
            x = x.to(torch.float32)
        return x.cpu().numpy()
    if isinstance(x, int):
        return np.asarray(x, np.int32)  # the reference's int32 counter
    return np.asarray(x)


def save_state(path: str, state: TriTDState) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {name: _np_savable(getattr(state, name)) for name in _FIELDS}
    np.savez_compressed(path, **arrays)
    return path


def _np_dtype(dtype: torch.dtype):
    return np.dtype(str(dtype).removeprefix("torch."))


def load_state(
    path: str, dtype=None, d=None, einsum_dtype=None, storage_dtype=None, device="cpu"
) -> TriTDState:
    """Load a TriTDState checkpoint onto `device`.

    Args:
      path: .npz written by :func:`save_state` (of either package).
      dtype: when set (a torch dtype), recast the solver arrays to it.
      d: the observed tensor; needed only to backfill the carried target `t`
        for a checkpoint written without it (t = d - o + y_l/mu_l).
      einsum_dtype: cfg.torch_einsum_dtype(); `t` is recast to it (else to
        the storage dtype, else to `dtype`), as the solver carries it.
      storage_dtype: the narrow storage dtype when the run uses one; the
        data-sized fields (o, e, y_l, y_o) are recast to it.

    The host fields come back as the solver keeps them: mu_l/mu_o numpy
    scalars, k an int, done a 0-d bool tensor on `device`.
    """
    with np.load(path) as f:
        arrays = {name: f[name] for name in _FIELDS if name in f}
    missing = [name for name in _FIELDS if name not in arrays and name != "t"]
    if missing:
        raise KeyError(f"checkpoint {path!r} missing fields {missing}")
    kwargs = {
        name: torch.as_tensor(arr, device=device)
        for name, arr in arrays.items() if name not in _HOST_FIELDS
    }
    kwargs.update(
        mu_l=arrays["mu_l"][()], mu_o=arrays["mu_o"][()], k=int(arrays["k"]),
        done=torch.as_tensor(bool(arrays["done"]), device=device),
    )
    if dtype is not None:
        for name in ("a", "b", "c"):
            kwargs[name] = kwargs[name].to(dtype)
        for name in ("mu_l", "mu_o"):
            kwargs[name] = _np_dtype(dtype).type(kwargs[name])
        sd = storage_dtype if storage_dtype is not None else dtype
        for name in ("o", "e", "y_l", "y_o"):
            kwargs[name] = narrow_cast(kwargs[name], sd)
    if "t" not in kwargs:
        if d is None:
            raise ValueError(
                f"checkpoint {path!r} has no carried field 't'; pass the "
                "observed tensor d to load_state to reconstruct it"
            )
        o, mu_l = kwargs["o"], kwargs["mu_l"]
        # The reference's order: d into O's dtype (one rounding), D - O in
        # that dtype (a narrow one through float32, as XLA computes it), then
        # Y_L / mu_l in mu_l's dtype.
        dn = narrow_cast(torch.as_tensor(d).to(device), o.dtype)
        diff = dn - o if o.dtype in (torch.float32, torch.float64) else narrow_cast(dn.float() - o.float(), o.dtype)
        wide = torch.float64 if torch.float64 in (o.dtype, torch.from_numpy(np.asarray(mu_l)).dtype) else torch.float32
        kwargs["t"] = diff.to(wide) + kwargs["y_l"].to(wide) / float(mu_l)
    t_dtype = einsum_dtype if einsum_dtype is not None else (storage_dtype if storage_dtype is not None else dtype)
    if t_dtype is None and kwargs["t"].dtype != kwargs["o"].dtype:
        t_dtype = kwargs["o"].dtype  # a rebuilt t is carried in O's dtype
    if t_dtype is not None:
        kwargs["t"] = narrow_cast(kwargs["t"], t_dtype)
    return TriTDState(**kwargs)


class CheckpointManager:
    """Every-N-iterations checkpointer (.npz)."""

    def __init__(self, directory: str, every: int = 25, use_orbax: bool = False):
        if use_orbax:
            raise NotImplementedError(
                "use_orbax: Orbax is a JAX library; the port writes .npz only "
                "(ROADMAP, do-not-port list)"
            )
        self.directory = directory
        self.every = every

    def maybe_save(self, state: TriTDState) -> str | None:
        k = int(state.k)
        if k == 0 or k % self.every:
            return None
        return save_state(os.path.join(self.directory, f"step_{k:06d}.npz"), state)

    def latest(self) -> str | None:
        if not os.path.isdir(self.directory):
            return None
        steps = sorted(p for p in os.listdir(self.directory) if p.startswith("step_"))
        return os.path.join(self.directory, steps[-1]) if steps else None
