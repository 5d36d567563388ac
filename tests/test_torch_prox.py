"""PyTorch port, the proximal layer: `ops/prox.py` against the JAX package,
and the port's own host C++ library (`runtime/native.py`, built by g++ from
`csrc/proximal.cpp`) against `ops/prox.py`, as `tests/test_runtime.py`
holds the JAX package's.

Tolerances: `capped_simplex_projection` and `flsa` rtol 1e-10 (atol 1e-12)
against JAX at float64: the same fixed-trip loops in the same order. The
native library is exact where the tensor versions iterate: atol 1e-5
(simplex, 64 bisections of a range of a few units resolve far below that)
and 2e-3 (FLSA, 5000 FISTA steps), the bounds of the JAX package's test.
Without g++ the native tests skip with a reason, and the fallback is tested
instead.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tritd_tpu.ops import prox as jprox  # noqa: E402
from tritd_tpu_torch.ops import prox  # noqa: E402
from tritd_tpu_torch.runtime import build, native  # noqa: E402

SIMPLEX_CASES = ((40, 7.0), (100, 25.5), (10, 0.0), (10, 10.0), (17, 3.1))
FLSA_CASES = ((0.0, 0.5), (0.2, 1.0), (1.0, 0.1))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def have_native():
    if not native.available():
        pytest.skip("no g++: the host proximal library cannot be built")


@pytest.mark.parametrize("n, s", SIMPLEX_CASES)
def test_capped_simplex_matches_jax(n, s):
    v = np.random.default_rng(0).normal(size=n) * 2.0
    with jax.enable_x64(True):
        want = np.asarray(jprox.capped_simplex_projection(v, s))
    got = prox.capped_simplex_projection(torch.from_numpy(v), s)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    assert (got >= 0).all() and (got <= 1).all()
    np.testing.assert_allclose(float(got.sum()), np.clip(s, 0, n), atol=1e-8)
    fewer = prox.capped_simplex_projection(torch.from_numpy(v), torch.tensor(s), iters=20)
    np.testing.assert_allclose(fewer.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("lam1, lam2", FLSA_CASES)
@pytest.mark.parametrize("iters", [50, 200])
def test_flsa_matches_jax(lam1, lam2, iters):
    v = np.random.default_rng(1).normal(size=60).cumsum()  # a random walk
    with jax.enable_x64(True):
        want = np.asarray(jprox.flsa(v, lam1, lam2, iters=iters))
    got = prox.flsa(torch.from_numpy(v), lam1, lam2, iters=iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    got32 = prox.flsa(torch.from_numpy(v).float(), lam1, lam2, iters=iters)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want, atol=1e-3)


def test_native_library_builds_into_the_package(have_native):
    path = build.build_host_library()
    assert path is not None and path.parent == build.BUILD_DIR and path.exists()
    assert path == build.build_host_library()  # cached by source hash


@pytest.mark.parametrize("n, s", SIMPLEX_CASES)
def test_capped_simplex_native_vs_torch(have_native, n, s):
    v = np.random.default_rng(0).normal(size=n) * 2.0
    got = native.capped_simplex_projection(v, s)
    assert (got >= -1e-12).all() and (got <= 1 + 1e-12).all()
    np.testing.assert_allclose(got.sum(), np.clip(s, 0, n), atol=1e-8)
    want = prox.capped_simplex_projection(torch.from_numpy(v), s).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("lam1, lam2", FLSA_CASES)
def test_flsa_native_vs_torch(have_native, lam1, lam2):
    v = np.random.default_rng(1).normal(size=60).cumsum()
    got = native.flsa(v, lam1, lam2)
    want = prox.flsa(torch.from_numpy(v), lam1, lam2, iters=5000).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_flsa_native_objective_optimal(have_native):
    """The native (exact Condat) FLSA objective is no worse than the
    iterative solution's."""
    v = np.random.default_rng(2).normal(size=80) * 3
    lam1, lam2 = 0.3, 0.7

    def obj(x):
        return 0.5 * np.sum((x - v) ** 2) + lam1 * np.abs(x).sum() + lam2 * np.abs(np.diff(x)).sum()

    x_iter = prox.flsa(torch.from_numpy(v), lam1, lam2, iters=5000).numpy()
    assert obj(native.flsa(v, lam1, lam2)) <= obj(x_iter) + 1e-4


def test_native_soft_threshold(have_native):
    v = np.array([-3.0, -0.5, 0.0, 0.2, 2.0])
    np.testing.assert_allclose(native.soft_threshold(v, 1.0), [-2.0, 0.0, 0.0, 0.0, 1.0])


def test_native_falls_back_to_ops_prox_without_a_compiler(monkeypatch):
    """With no library, every entry point answers from `ops/prox.py` (numpy
    for the soft threshold), float64 numpy in and out."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    assert not native.available()
    v = np.random.default_rng(3).normal(size=30).cumsum()
    got = native.capped_simplex_projection(v, 4.0)
    want = prox.capped_simplex_projection(torch.from_numpy(v), 4.0).numpy()
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.flsa(v, 0.2, 1.0),
                                  prox.flsa(torch.from_numpy(v), 0.2, 1.0, iters=2000).numpy())
    np.testing.assert_allclose(native.soft_threshold(v, 1.0),
                               np.sign(v) * np.maximum(np.abs(v) - 1.0, 0.0))
