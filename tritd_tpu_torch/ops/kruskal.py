"""Kruskal/CP tensor utilities: `khatrirao`, `ktensor_full`, `tenmat`,
`tenrand`, `cp_normalize`, `create_problem`.

PyTorch counterpart of `tritd_tpu/ops/kruskal.py`. A CP tensor is just
`(weights, [u1, ..., uN])`; tensors in, tensors out, on the device of the
input.

Where the reference takes a `jax.random` key, the functions here take
`generator: torch.Generator | None` (default: seed 0) and, having no input
tensor to read them from, `device` and `dtype`. Numbers are drawn on the
generator's device (the CPU for the default one), so one seed gives one draw
on every device, then moved. With `device=None` a constructor builds on the
GPU when there is one and on the CPU otherwise.

`ktensor_full` fixes its contraction order (Khatri-Rao of all factors but
the last, then one GEMM with the last), so the result and the memory taken
do not depend on whether an einsum path optimizer is installed: the largest
intermediate is prod(n[:-1]) x R, never prod(n) x R.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means the GPU when there is one,
    else the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def default_generator(generator: torch.Generator | None) -> torch.Generator:
    """`generator`, or a CPU generator with seed 0 (the reference's
    `PRNGKey(0)` default)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return generator


def draw(kind: str, generator, shape, dtype, device) -> torch.Tensor:
    """`torch.rand` ("uniform") or `torch.randn` ("normal") on the
    generator's device, moved to `device`."""
    fn = {"uniform": torch.rand, "normal": torch.randn}[kind]
    out = fn(tuple(shape), generator=generator, dtype=dtype, device=generator.device)
    return out.to(device)


def khatrirao(*mats: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Column-wise Khatri-Rao product of (n_i, R) matrices -> (prod n_i, R).

    Matches Tensor Toolbox `khatrirao` (row ordering of the FIRST matrix
    varying slowest; `reverse=True` flips the operand order, as the toolbox's
    'r' flag does)."""
    ms = list(mats[::-1]) if reverse else list(mats)
    r = ms[0].shape[1]
    out = ms[0]
    for m in ms[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, r)
    return out


def ktensor_full(factors, weights=None) -> torch.Tensor:
    """Dense tensor of a Kruskal operator — `double(full(ktensor(U)))`."""
    factors = list(factors)
    shape = tuple(u.shape[0] for u in factors)
    first = factors[0] if weights is None else factors[0] * weights[None, :]
    if len(factors) == 1:
        return first.sum(dim=1)
    kr = khatrirao(first, *factors[1:-1])
    return (kr @ factors[-1].T).reshape(shape)


def tenmat(x: torch.Tensor, row_modes, col_modes=None) -> torch.Tensor:
    """Matricize a tensor with the given row (and optional column) modes —
    the `tenmat` class collapsed to a function. Modes are 0-indexed."""
    n = x.ndim
    row_modes = tuple(row_modes)
    if col_modes is None:
        col_modes = tuple(m for m in range(n) if m not in row_modes)
    else:
        col_modes = tuple(col_modes)
    xp = x.permute(row_modes + col_modes)
    rows = 1
    for m in row_modes:
        rows *= x.shape[m]
    return xp.reshape(rows, -1)


def tenrand(generator, shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform [0,1) random tensor — `tenrand`."""
    return draw("uniform", default_generator(generator), shape, dtype, default_device(device))


def cp_normalize(factors, weights=None):
    """Normalize factor columns to unit l2 norm, absorbing norms into the
    weight vector — `ktensor/normalize` semantics."""
    r = factors[0].shape[1]
    if weights is None:
        weights = torch.ones((r,), dtype=factors[0].dtype, device=factors[0].device)
    new_factors = []
    for u in factors:
        norms = torch.linalg.vector_norm(u, dim=0)
        safe = torch.where(norms > 0, norms, torch.ones_like(norms))
        new_factors.append(u / safe)
        weights = weights * norms
    return new_factors, weights


def create_problem(
    generator,
    shape,
    rank: int,
    noise: float = 0.1,
    dtype=torch.float32,
    device=None,
):
    """Synthetic CP problem a la Tensor Toolbox `create_problem` (used by
    SOFIA's `make_synthetic.m:11-27`): random factors, dense full tensor,
    additive Gaussian noise of relative magnitude `noise`."""
    generator = default_generator(generator)
    device = default_device(device)
    factors = [draw("normal", generator, (s, rank), dtype, device) for s in shape]
    clean = ktensor_full(factors)
    nz = draw("normal", generator, clean.shape, dtype, device)
    data = clean + noise * torch.linalg.vector_norm(clean) / (
        torch.linalg.vector_norm(nz) + 1e-30
    ) * nz
    return {"factors": factors, "clean": clean, "data": data}
