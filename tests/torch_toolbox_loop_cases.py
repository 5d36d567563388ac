"""The ten Tensor Toolbox functions whose loops run through
`tritd_tpu_torch/ops/toolbox_loop.py`, each a call on small inputs made
from a seed with numpy (not a test file). Shared by
`tests/test_torch_toolbox_loops.py` (the CPU) and `tests/test_torch_cuda.py`
(the card); imports no JAX.

`call(name, tol, device, dtype)` runs one function to at most
`MAX_ITERS[name]` iterations at `tol`; `EARLY_TOL[name]` is a tol that
stops it early (between 2 and max_iters - 1 iterations in float64 on the
CPU and in float32 on the card), 0 one that never does. `on_device` makes
the inputs tensors beforehand, so that a call copies nothing from the
host."""

import itertools

import numpy as np
import torch

from tritd_tpu_torch import ops

SHAPE = (6, 7, 8)
RANK = 2
SYM_N = 5

NAMES = ("cp_als", "cp_als_sparse", "cp_nmu", "cp_apr", "cp_arls",
         "eig_sshopm", "eig_sshopmc", "eig_geap", "gcp_opt", "cp_sym")
MAX_ITERS = {"cp_als": 40, "cp_als_sparse": 40, "cp_nmu": 40, "cp_apr": 12, "cp_arls": 30,
             "eig_sshopm": 60, "eig_sshopmc": 60, "eig_geap": 60, "gcp_opt": 40, "cp_sym": 40}
EARLY_TOL = {"cp_als": 1e-3, "cp_als_sparse": 1e-3, "cp_nmu": 1e-3, "cp_apr": 3e-2, "cp_arls": 3e-3,
             "eig_sshopm": 1e-4, "eig_sshopmc": 1e-3, "eig_geap": 1e-4, "gcp_opt": 0.3, "cp_sym": 1e-3}


def _symmetrize(x: np.ndarray) -> np.ndarray:
    perms = list(itertools.permutations(range(x.ndim)))
    return sum(x.transpose(p) for p in perms) / len(perms)


def inputs(seed: int = 0) -> dict:
    """The numpy float64 inputs of every case."""
    g = np.random.default_rng(seed)
    truth = [g.random((s, RANK)) + 0.1 for s in SHAPE]
    x = np.einsum("ir,jr,kr->ijk", *truth)
    x = x + 0.05 * x.mean() * g.random(SHAPE)  # noise: fits stay away from 1
    keep = g.random(SHAPE) < 0.6
    u = np.linalg.qr(g.standard_normal((SYM_N, 2)))[0]
    a = (3.0 * np.einsum("i,j,k,l->ijkl", *[u[:, 0]] * 4) + np.einsum("i,j,k,l->ijkl", *[u[:, 1]] * 4)
         + 0.05 * _symmetrize(g.standard_normal((SYM_N,) * 4)))
    w_sym, u_sym = np.array([2.0, -1.0]), g.standard_normal((SYM_N, 2))
    return {
        "x": x,
        "counts": g.poisson(20.0 * x).astype(np.float64),
        "init": [g.random((s, RANK)) for s in SHAPE],
        "vals": x[keep], "coords": np.argwhere(keep),
        "a": a, "x0": g.standard_normal(SYM_N),
        "x0c": g.standard_normal(SYM_N) + 1j * g.standard_normal(SYM_N),
        "sym3": np.einsum("r,ir,jr,kr->ijk", w_sym, u_sym, u_sym, u_sym),
        "sym_init": (g.standard_normal(2), g.standard_normal((SYM_N, 2)) / np.sqrt(SYM_N)),
        "eye": ops.teneye(4, SYM_N, dtype=torch.float64, device="cpu").numpy(),
    }


def _on(value, device, dtype):
    if isinstance(value, (list, tuple)):
        return [_on(v, device, dtype) for v in value]
    if isinstance(value, torch.Tensor):
        return value
    t = torch.from_numpy(np.asarray(value))
    if t.dtype == torch.int64:
        return t.to(device)
    if t.is_complex():
        return t.to(device=device, dtype=torch.complex64 if dtype == torch.float32 else torch.complex128)
    return t.to(device=device, dtype=dtype)


def on_device(data: dict, device, dtype) -> dict:
    """`inputs()` as tensors on `device`: floats in `dtype`, complex in the
    matching complex dtype, coordinates int64."""
    return {k: _on(v, device, dtype) for k, v in data.items()}


def call(name: str, tol: float, device="cpu", dtype=torch.float64, max_iters: int | None = None,
         data: dict | None = None) -> dict:
    """One call of `name` on `inputs()` (or `data`, numpy or `on_device`'s)
    as tensors on `device`."""
    d = on_device(data or inputs(), device, dtype)
    m = MAX_ITERS[name] if max_iters is None else max_iters
    if name == "cp_als":
        return ops.cp_als(d["x"], RANK, max_iters=m, tol=tol, init_factors=d["init"])
    if name == "cp_als_sparse":
        return ops.cp_als_sparse(d["vals"], d["coords"], SHAPE, RANK, max_iters=m, tol=tol, init_factors=d["init"])
    if name == "cp_nmu":
        return ops.cp_nmu(d["x"], RANK, max_iters=m, tol=tol, init_factors=d["init"])
    if name == "cp_apr":
        return ops.cp_apr(d["counts"], RANK, max_outer=m, max_inner=3, tol=tol, init_factors=d["init"])
    if name == "cp_arls":
        return ops.cp_arls(d["x"], RANK, n_samples=30, max_iters=m, tol=tol,
                           generator=torch.Generator().manual_seed(1), init_factors=d["init"])
    if name == "eig_sshopm":
        return ops.eig_sshopm(d["a"], shift=2.0, max_iters=m, tol=tol, x0=d["x0"])
    if name == "eig_sshopmc":
        return ops.eig_sshopmc(d["a"], shift=2.0, max_iters=m, tol=tol, x0=d["x0c"])
    if name == "eig_geap":
        return ops.eig_geap(d["a"], d["eye"], shift=3.0, max_iters=m, tol=tol, x0=d["x0"])
    if name == "gcp_opt":  # a bounded loss: the projection runs in every step
        return ops.gcp_opt(d["counts"], RANK, loss="count", max_iters=m, learning_rate=0.05, tol=tol,
                           init_factors=[0.5 * u + 0.01 for u in d["init"]])
    if name == "cp_sym":
        return ops.cp_sym(d["sym3"], RANK, max_iters=m, learning_rate=0.05, tol=tol, init=d["sym_init"])
    raise KeyError(name)


def tensors(res: dict) -> dict:
    """The tensors of a result dict by key (the factors as factors.0, ...)."""
    out = {}
    for key, value in res.items():
        if isinstance(value, torch.Tensor):
            out[key] = value
        elif isinstance(value, (list, tuple)):
            out.update({f"{key}.{i}": v for i, v in enumerate(value)})
    return out


def same_bits(got: dict, want: dict) -> list:
    """The keys of two results whose tensors differ in a bit, or n_iters."""
    g, w = tensors(got), tensors(want)
    differ = [k for k in w if not (g[k].dtype == w[k].dtype and g[k].shape == w[k].shape and torch.equal(
        g[k].detach().reshape(-1).view(torch.uint8), w[k].detach().reshape(-1).view(torch.uint8)))]
    if got["n_iters"] != want["n_iters"]:
        differ.append("n_iters")
    return differ
