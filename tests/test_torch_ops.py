"""PyTorch port, L0 ops: fold, designs, normal equations and shrinkage held
against their JAX counterparts in tritd_tpu on the same numpy inputs, and
against the MATLAB golden literals of test_golden.py.

Tolerance: float64 on both sides, rtol 1e-12 — only summation order differs
(XLA's einsum paths vs the port's explicit GEMM + contraction), so the two
agree to a few ulps of the largest partial sum."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_golden import (  # noqa: E402
    BUILD_F,
    BUILD_G,
    BUILD_H,
    TRIPLE_PRODUCT,
    UNFOLD_1,
    UNFOLD_2,
    UNFOLD_3,
    _fixture_cores,
    _fixture_tensor,
    _pair_perm,
)

# tritd_tpu.ops re-exports functions named like its modules, so fetch the
# modules themselves
jdesigns = importlib.import_module("tritd_tpu.ops.designs")
jfold = importlib.import_module("tritd_tpu.ops.fold")
jne = importlib.import_module("tritd_tpu.ops.normal_eq")
from tritd_tpu.ops.shrinkage import soft_threshold as j_soft  # noqa: E402
from tritd_tpu_torch.ops import designs, fold, normal_eq  # noqa: E402
from tritd_tpu_torch.ops.shrinkage import soft_threshold  # noqa: E402

RTOL = 1e-12
SHAPE = (12, 10, 14)
R = 3
VARIANTS = ("hadamard", "full")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cores(seed=0, shape=SHAPE, r=R):
    rng = np.random.default_rng(seed)
    n1, n2, n3 = shape
    return (
        rng.standard_normal((n1, r, r)),
        rng.standard_normal((r, n2, r)),
        rng.standard_normal((r, r, n3)),
    )


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# --- fold -------------------------------------------------------------------


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_unfold_fold_match_jax(mode):
    x = np.random.default_rng(1).standard_normal(SHAPE)
    with jax.enable_x64(True):
        want = np.asarray(jfold.unfold(jnp.asarray(x), mode))
    got = fold.unfold(_t(x), mode)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fold.fold(got, mode, SHAPE).numpy(), x)


def test_unfold_matches_matlab_golden():
    x = torch.from_numpy(np.array(_fixture_tensor()))
    np.testing.assert_array_equal(fold.unfold(x, 1).numpy(), UNFOLD_1)
    np.testing.assert_array_equal(fold.unfold(x, 2).numpy(), UNFOLD_2)
    np.testing.assert_array_equal(fold.unfold(x, 3).numpy(), UNFOLD_3)


def test_core_flatteners_match_jax():
    a, b, c = _cores()
    with jax.enable_x64(True):
        ja, jb, jc = map(jnp.asarray, (a, b, c))
        want = [np.asarray(v) for v in (
            jfold.core_a_mat(ja), jfold.core_b_mat(jb), jfold.core_c_mat(jc),
            jfold.core_b_from_mat(jnp.asarray(b.reshape(R * R, -1).T.copy()), R),
            jfold.core_c_from_mat(jnp.asarray(c.reshape(R * R, -1).T.copy()), R),
        )]
    got = [
        fold.core_a_mat(_t(a)), fold.core_b_mat(_t(b)), fold.core_c_mat(_t(c)),
        fold.core_b_from_mat(_t(b.reshape(R * R, -1).T.copy()), R),
        fold.core_c_from_mat(_t(c.reshape(R * R, -1).T.copy()), R),
    ]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(fold.core_a_from_mat(fold.core_a_mat(_t(a)), R).numpy(), a)


# --- designs ----------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_designs_and_triple_product_match_jax(variant):
    a, b, c = _cores(2)
    with jax.enable_x64(True):
        ja, jb, jc = map(jnp.asarray, (a, b, c))
        want = {
            "f": jdesigns.build_f(jb, jc, variant),
            "g": jdesigns.build_g(ja, jc, variant),
            "h": jdesigns.build_h(ja, jb, variant),
            "l": jdesigns.triple_product(ja, jb, jc, variant),
            "naive": jdesigns.triple_product_naive(ja, jb, jc, variant),
        }
        want = {k: np.asarray(v) for k, v in want.items()}
    ta, tb, tc = map(_t, (a, b, c))
    _close(designs.build_f(tb, tc, variant), want["f"])
    _close(designs.build_g(ta, tc, variant), want["g"])
    _close(designs.build_h(ta, tb, variant), want["h"])
    _close(designs.triple_product(ta, tb, tc, variant), want["l"])
    _close(designs.triple_product_naive(ta, tb, tc, variant), want["naive"])


def test_designs_match_matlab_golden():
    a, b, c = map(_t, _fixture_cores())
    perm = _pair_perm(2)
    np.testing.assert_array_equal(designs.build_f(b, c).numpy(), BUILD_F[perm])
    np.testing.assert_array_equal(designs.build_g(a, c).numpy(), BUILD_G[perm])
    np.testing.assert_array_equal(designs.build_h(a, b).numpy(), BUILD_H[perm])
    np.testing.assert_array_equal(designs.triple_product(a, b, c).numpy(), TRIPLE_PRODUCT)


def test_unknown_variant_raises():
    a, b, c = map(_t, _cores())
    with pytest.raises(ValueError, match="variant"):
        designs.triple_product(a, b, c, variant="kron")


# --- normal equations -------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_gram_and_rhs_match_jax(variant, mode):
    a, b, c = _cores(3)
    x = np.random.default_rng(4).standard_normal(SHAPE)
    with jax.enable_x64(True):
        ja, jb, jc, jx = map(jnp.asarray, (a, b, c, x))
        jk, jrhs = jne.gram_and_rhs(mode, jx, ja, jb, jc, variant=variant)
        jgrams = [np.asarray(g) for g in (jne.gram_a(ja), jne.gram_b(jb), jne.gram_c(jc))]
        jk, jrhs = np.asarray(jk), np.asarray(jrhs)
    ta, tb, tc, tx = map(_t, (a, b, c, x))
    k, rhs = normal_eq.gram_and_rhs(mode, tx, ta, tb, tc, variant=variant)
    _close(k, jk)
    _close(rhs, jrhs)
    assert rhs.dtype == torch.float64
    for got, want in zip((normal_eq.gram_a(ta), normal_eq.gram_b(tb), normal_eq.gram_c(tc)), jgrams):
        _close(got, want)
    # the normal equations are those of the materialized designs
    design = {1: designs.build_f(tb, tc, variant), 2: designs.build_g(ta, tc, variant),
              3: designs.build_h(ta, tb, variant)}[mode]
    _close(k, design @ design.T)
    _close(rhs, fold.unfold(tx, mode) @ design.T)


@pytest.mark.parametrize("method", ["cholesky", "pinv", "lstsq"])
def test_ridge_solve_matches_jax(method):
    a, b, c = _cores(5)
    x = np.random.default_rng(6).standard_normal(SHAPE)
    ta, tb, tc, tx = map(_t, (a, b, c, x))
    k, rhs = normal_eq.gram_and_rhs(1, tx, ta, tb, tc)
    with jax.enable_x64(True):
        want = np.asarray(jne.ridge_solve(jnp.asarray(k.numpy()), jnp.asarray(rhs.numpy()), 1e-3, method))
    _close(normal_eq.ridge_solve(k, rhs, 1e-3, method), want)


def test_ridge_solve_rejects_unknown_method():
    k = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="method"):
        normal_eq.ridge_solve(k, k, 1e-3, "svd")


def test_soft_threshold_matches_jax():
    x = np.random.default_rng(7).standard_normal(200) * 3
    x[:3] = [0.0, np.nan, -0.0]
    with jax.enable_x64(True):
        want = np.asarray(j_soft(jnp.asarray(x), 1.1))
    np.testing.assert_array_equal(soft_threshold(_t(x), 1.1).numpy(), want)
