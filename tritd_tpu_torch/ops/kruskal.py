"""Kruskal/CP tensor utilities: `khatrirao`, `ktensor_full`, `tenmat`,
`tenrand`, `cp_normalize`, `create_problem`.

PyTorch counterpart of `tritd_tpu/ops/kruskal.py`. A CP tensor is just
`(weights, [u1, ..., uN])`; tensors in, tensors out, on the device of the
input.

Where the reference takes a `jax.random` key, the functions here take
`generator: torch.Generator | None` (default: seed 0) and, having no input
tensor to read them from, `device` and `dtype`. Numbers are drawn on the
generator's device (the CPU for the default one), so one seed gives one draw
on every device, then moved. `device=None` means the GPU: without CUDA a
constructor raises `RuntimeError` rather than build on the CPU, so pass
`device="cpu"` for the plain PyTorch path.

`ktensor_full` fixes its contraction order (Khatri-Rao of all factors but
the last, then one GEMM with the last), so the result and the memory taken
do not depend on whether an einsum path optimizer is installed: the largest
intermediate is prod(n[:-1]) x R, never prod(n) x R.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch


def default_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means `cuda`, and raises
    `RuntimeError` when CUDA is not available (no quiet fall back to the
    CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device cuda requested but CUDA is not available; "
                'pass device="cpu" to run the plain PyTorch path'
            )
        return torch.device("cuda")
    return torch.device(device)


def input_device(x, device=None) -> torch.device:
    """Where an entry point puts its input `x`: a tensor stays on its device
    unless `device` names another; anything else (a numpy array, a list) goes
    to `default_device(device)`: the card by default, which raises without
    CUDA, as the reference places an array on its accelerator."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.device
    return default_device(device)


def solver_input(x, dtype: torch.dtype | None = None, device=None) -> torch.Tensor | None:
    """`x` as a tensor of `dtype` (None: its own) on `input_device(x,
    device)`; None (an optional argument left out) stays None."""
    if x is None:
        return None
    return torch.as_tensor(x).to(device=input_device(x, device), dtype=dtype)


# The narrow dtypes numpy holds as `ml_dtypes` extension types, which torch
# cannot read: by name, the integer type their bits are carried in. float16
# is native to numpy.
CARRIED_BITWISE = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def _placed(x, place: torch.device, nested: bool = False):
    """A tensor moved to `place`, anything else made a tensor there (a numpy
    array of bfloat16 or a float8 format bit for bit, recognised by its
    dtype's name: no `ml_dtypes` import); with `nested`, a list or tuple is
    placed entry by entry (a list of factors, a `(weights, factors)` pair),
    its None entries (a mode left out) kept."""
    if nested and isinstance(x, (list, tuple)):
        return type(x)(_placed(u, place, nested) for u in x)
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(place)
    if isinstance(x, np.ndarray):
        # a read-only array (`np.asarray` of a JAX array) is copied: torch
        # warns on a tensor over memory it may not write
        x = x if x.flags.writeable else np.array(x)
        if x.dtype.name in CARRIED_BITWISE:
            bits, dtype = CARRIED_BITWISE[x.dtype.name]
            return torch.from_numpy(np.ascontiguousarray(x).view(bits)).view(dtype).to(place)
    return torch.as_tensor(x, device=place)


def _all_tensors(x, nested: bool) -> bool:
    if nested and isinstance(x, (list, tuple)):
        return all(u is None or _all_tensors(u, nested) for u in x)
    return isinstance(x, torch.Tensor)


def _first(x, nested: bool):
    while nested and isinstance(x, (list, tuple)) and x:
        x = next((u for u in x if u is not None), None)
    return x


def on_input_device(*names: str, sequences: tuple[str, ...] = ()):
    """Decorator: the entry-point rule of `solver_input` for a function's
    data arguments. The wrapped function takes `device=None` as a keyword.
    The arguments `names` are data tensors; those of `sequences` are a
    tensor or a list or tuple of them (nested: a list of factors, a
    `(weights, factors)` pair). When each of them that is given is made of
    tensors and `device` is None, the call goes through untouched.
    Otherwise the first one given is the main input: it goes to
    `input_device(main, device)` (a tensor keeps its device unless `device`
    names another; numpy or a list goes to the card, and raises
    `RuntimeError` without CUDA), and the others follow it there. A numpy
    array keeps its dtype."""
    def wrap(fn):
        sig = inspect.signature(fn)
        # (position, name, nested, takes the rest) of each data argument; the
        # position lets an all-tensor call be checked without binding
        at = [(i, p, p in sequences, q.kind is q.VAR_POSITIONAL)
              for i, (p, q) in enumerate(sig.parameters.items()) if p in names or p in sequences]

        def all_tensors(args, kwargs) -> bool:
            for i, p, nested, rest in at:
                v = args[i:] if rest else args[i] if i < len(args) else kwargs.get(p)
                if v is not None and not _all_tensors(v, nested):
                    return False
            return True

        @functools.wraps(fn)
        def inner(*args, device=None, **kwargs):
            if device is None and all_tensors(args, kwargs):
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            given = [(p, nested, bound.arguments[p]) for _i, p, nested, _rest in at
                     if bound.arguments.get(p) is not None]
            if not given:
                return fn(*args, **kwargs)
            _p, nested, main = given[0]
            place = input_device(_first(main, nested), device)
            for p, nested, v in given:
                bound.arguments[p] = _placed(v, place, nested)
            return fn(*bound.args, **bound.kwargs)

        # the signature shown is fn's with `device=None` among its keywords
        params = list(sig.parameters.values())
        at_kw = next((i for i, q in enumerate(params) if q.kind is q.VAR_KEYWORD), len(params))
        params.insert(at_kw, inspect.Parameter("device", inspect.Parameter.KEYWORD_ONLY, default=None))
        inner.__signature__ = sig.replace(parameters=params)
        return inner

    return wrap


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


@on_input_device(sequences=("mats",))
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


@on_input_device("weights", sequences=("factors",))
def ktensor_full(factors, weights=None) -> torch.Tensor:
    """Dense tensor of a Kruskal operator — `double(full(ktensor(U)))`."""
    factors = list(factors)
    shape = tuple(u.shape[0] for u in factors)
    first = factors[0] if weights is None else factors[0] * weights[None, :]
    if len(factors) == 1:
        return first.sum(dim=1)
    kr = khatrirao(first, *factors[1:-1])
    return (kr @ factors[-1].T).reshape(shape)


@on_input_device("x")
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


@on_input_device("weights", sequences=("factors",))
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
