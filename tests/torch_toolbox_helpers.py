"""Shared helpers of the Tensor Toolbox parity tests (not a test file).

Inputs are numpy float64 arrays made from a seed; the JAX side runs under
`jax.enable_x64(True)`, the torch side on CPU float64 tensors."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

#: closed-form functions: only the summation order differs
RTOL_CLOSED = 1e-10
#: iterative functions run to the same `n_iters` from the same init
RTOL_ITER = 1e-8


def x64():
    """Context in which the JAX reference computes in float64."""
    return jax.enable_x64(True)


def rng(seed=0):
    return np.random.default_rng(seed)


def t(x, dtype=torch.float64):
    """numpy (or JAX) array -> CPU tensor holding a copy."""
    return torch.from_numpy(np.array(x)).to(dtype)


def tl(xs, dtype=torch.float64):
    return [t(x, dtype) for x in xs]


def j(x):
    """numpy -> JAX array (float64 inside `x64()`)."""
    return jnp.asarray(x)


def jl(xs):
    return [jnp.asarray(x) for x in xs]


def n(x):
    """tensor / JAX array / number -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(got, want, rtol=RTOL_CLOSED, atol=None):
    """`got` (port) against `want` (reference): rtol on each entry plus
    rtol times the largest |want| as the absolute floor."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if atol is None:
        atol = rtol * max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def projector(u):
    u = n(u)
    return u @ np.conj(u.T)


def random_factors(shape, rank, seed=0, kind="normal", offset=0.0):
    g = rng(seed)
    draw = g.standard_normal if kind == "normal" else g.random
    return [draw((s, rank)) + offset for s in shape]


def np_ktensor_full(factors, weights=None):
    letters = "ijklmnop"[: len(factors)]
    spec = ",".join(f"{c}r" for c in letters) + ",r->" + letters
    r = factors[0].shape[1]
    w = np.ones(r) if weights is None else np.asarray(weights)
    return np.einsum(spec, *factors, w)


def np_symmetrize(x):
    import itertools

    perms = list(itertools.permutations(range(x.ndim)))
    return sum(np.transpose(x, p) for p in perms) / len(perms)


@contextlib.contextmanager
def one_torch_thread():
    """The tensors are tiny: one intra-op thread keeps the test workers from
    oversubscribing the cores."""
    k = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(k)
