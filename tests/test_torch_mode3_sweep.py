"""PyTorch port, SOFIA's mode-3 step (`tritd_tpu_torch/ops/sofia_kernels.py`:
`mode3_sweep`, its plain version `mode3_sweep_torch`), on the CPU.

The plain version against the JAX package's `_mode3_gauss_seidel` on the
same numpy float64 inputs (rtol 1e-12: both invert each system in the same
closed form for r <= 3, by Cholesky above, and sweep the rows in the same
order), over periods m = 1, m = n3 - 1, m >= n3 and one row; bitwise the
systems and the sweep it stands for (`_mode3_systems`,
`gauss_seidel_sweep_torch`), which `baselines/sofia.py` ran before the step
became one kernel. A numpy model of the kernel's systems for r <= 3 (each
product, difference and quotient rounded on its own, as the kernel's *_rn
intrinsics do) gives `_mode3_systems`' bits in float32 and float64. The
checks of what the kernel takes, and NaN rows from a system Cholesky cannot
factor. The kernel itself runs in `tests/test_torch_cuda.py`.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu_torch.ops import sofia_kernels  # noqa: E402

jsofia = importlib.import_module("tritd_tpu.baselines.sofia")
sofia = importlib.import_module("tritd_tpu_torch.baselines.sofia")

LAM1, LAM2 = 0.3, 0.15
# (n3, m): a period of 1, of n3 - 1, at and past n3, one row, a seasonal case
SHAPES = [(12, 1), (12, 11), (12, 12), (9, 20), (1, 1), (1, 3), (37, 7)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(n3, r, seed=0):
    """(u3, rhs_base, gram_base): old rows, right-hand sides and PD grams."""
    rng = np.random.default_rng(seed + 31 * n3 + r)
    g = rng.standard_normal((n3, r, r))
    gram = np.einsum("tij,tkj->tik", g, g) / r + 0.5 * np.eye(r)
    return rng.standard_normal((n3, r)), rng.standard_normal((n3, r)), gram


@pytest.mark.parametrize("r", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n3, m", SHAPES)
def test_mode3_sweep_plain_version_matches_jax(n3, r, m):
    u3, rhs, gram = _inputs(n3, r)
    got = sofia_kernels.mode3_sweep_torch(_t(u3), _t(rhs), _t(gram), LAM1, LAM2, m).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jsofia._mode3_gauss_seidel(jnp.asarray(u3), jnp.asarray(rhs), jnp.asarray(gram),
                                                     LAM1, LAM2, m))
    assert got.shape == want.shape == (n3, r) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n3, r, m", [(37, 3, 7), (20, 1, 1), (16, 2, 15), (11, 5, 4), (6, 8, 9)])
def test_mode3_sweep_is_the_systems_and_the_sweep_bitwise(n3, r, m, dtype):
    """The wrapper on the CPU, its plain version and the step through
    `baselines/sofia.py` are the systems and the sweep the port ran before."""
    args = [_t(a).to(dtype) for a in _inputs(n3, r, seed=1)]
    before = sofia_kernels.gauss_seidel_sweep_torch(*sofia._mode3_systems(*args, LAM1, LAM2, m), LAM1, LAM2, m)
    for got in (sofia_kernels.mode3_sweep_torch(*args, LAM1, LAM2, m), sofia_kernels.mode3_sweep(*args, LAM1, LAM2, m),
                sofia._mode3_gauss_seidel(*args, LAM1, LAM2, m)):
        assert got.dtype == dtype and torch.equal(got, before)


def _kernel_systems_model(u3, rhs_base, gram_base, lam1, lam2, m):
    """The kernel's systems for r <= 3 (`adjugate_slot`, `rhs0_at` in
    `csrc/sofia_kernels.cu`) in numpy scalars of the inputs' dtype: every
    operation rounded on its own, in the kernel's order."""
    dt = u3.dtype.type
    n3, r = u3.shape
    l1, l2, one, zero = dt(lam1), dt(lam2), dt(1), dt(0)
    inv = np.empty((n3, r, r), u3.dtype)
    rhs0 = np.empty((n3, r), u3.dtype)
    for t in range(n3):
        hp, hn = dt(t > 0), dt(t < n3 - 1)
        uf, ub = dt(t < n3 - m), dt(t >= m)
        d = l1 * (hp + hn) + l2 * (uf + ub)
        a = [[gram_base[t, i, j] + d * (one if i == j else zero) for j in range(r)] for i in range(r)]
        if r == 1:
            inv[t] = one / a[0][0]
        elif r == 2:
            det = a[0][0] * a[1][1] - a[0][1] * a[1][0]
            inv[t] = np.array([[a[1][1] / det, -a[0][1] / det], [-a[1][0] / det, a[0][0] / det]])
        else:
            def cof(i0, j0, i1, j1, i2, j2, i3, j3):
                return a[i0][j0] * a[i1][j1] - a[i2][j2] * a[i3][j3]

            det = (a[0][0] * cof(1, 1, 2, 2, 1, 2, 2, 1) - a[0][1] * cof(1, 0, 2, 2, 1, 2, 2, 0)) \
                + a[0][2] * cof(1, 0, 2, 1, 1, 1, 2, 0)
            adj = [cof(1, 1, 2, 2, 1, 2, 2, 1), cof(0, 2, 2, 1, 0, 1, 2, 2), cof(0, 1, 1, 2, 0, 2, 1, 1),
                   cof(1, 2, 2, 0, 1, 0, 2, 2), cof(0, 0, 2, 2, 0, 2, 2, 0), cof(0, 2, 1, 0, 0, 0, 1, 2),
                   cof(1, 0, 2, 1, 1, 1, 2, 0), cof(0, 1, 2, 0, 0, 0, 2, 1), cof(0, 0, 1, 1, 0, 1, 1, 0)]
            inv[t] = np.array([e / det for e in adj]).reshape(3, 3)
        nxt, fwd = (t + 1) % n3, (t + m) % n3
        for j in range(r):
            s = rhs_base[t, j] + (l1 * hn) * u3[nxt, j]
            rhs0[t, j] = s + (l2 * uf) * u3[fwd, j]
    return rhs0, inv


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("n3, m", [(40, 7), (9, 1), (8, 8)])
def test_kernel_systems_model_is_the_plain_systems_bitwise(n3, r, m, dtype):
    u3, rhs, gram = (a.astype(dtype) for a in _inputs(n3, r, seed=2))
    want_rhs0, want_inv = sofia._mode3_systems(_t(u3), _t(rhs), _t(gram), LAM1, LAM2, m)
    with np.errstate(all="raise"):
        rhs0, inv = _kernel_systems_model(u3, rhs, gram, LAM1, LAM2, m)
    assert np.array_equal(rhs0, want_rhs0.numpy()) and np.array_equal(inv, want_inv.numpy())


def test_the_kernel_checks_what_it_takes():
    n3, r = 6, 3
    u3, rhs, gram = torch.zeros(n3, r), torch.zeros(n3, r), torch.zeros(n3, r, r)
    assert sofia_kernels._mode3_check(u3, rhs, gram) == "f32"
    assert sofia_kernels._mode3_check(u3.double(), rhs.double(), gram.double()) == "f64"
    with pytest.raises(TypeError, match="float32 or float64"):
        sofia_kernels._mode3_check(u3.half(), rhs.half(), gram.half())
    with pytest.raises(TypeError, match="float32 or float64"):
        sofia_kernels._mode3_check(u3.bfloat16(), rhs.bfloat16(), gram.bfloat16())
    with pytest.raises(ValueError, match="one dtype"):
        sofia_kernels._mode3_check(u3, rhs.double(), gram)
    with pytest.raises(ValueError, match="contiguous"):
        sofia_kernels._mode3_check(u3, torch.zeros(r, n3).T, gram)
    with pytest.raises(ValueError, match="contiguous"):
        sofia_kernels._mode3_check(u3, rhs, gram.transpose(1, 2))
    with pytest.raises(ValueError, match="shapes"):
        sofia_kernels._mode3_check(u3, rhs, torch.zeros(n3, r, r + 1))
    with pytest.raises(ValueError, match="shapes"):
        sofia_kernels._mode3_check(u3, torch.zeros(n3 + 1, r), gram)
    wide = sofia_kernels.MAX_RANK + 1
    with pytest.raises(ValueError, match=f"ranks 1 to {sofia_kernels.MAX_RANK}"):
        sofia_kernels._mode3_check(torch.zeros(2, wide), torch.zeros(2, wide), torch.zeros(2, wide, wide))
    for m in (0, -3):
        with pytest.raises(ValueError, match="at least 1"):
            sofia_kernels.mode3_sweep(u3, rhs, gram, LAM1, LAM2, m)


@pytest.mark.parametrize("r", [4, 8])
def test_a_system_cholesky_cannot_factor_turns_the_rows_nan(r):
    """From the row whose system is not positive definite on, every row is
    NaN (the chain carries it), as the reference's Cholesky gives; the rows
    before it are the sweep's."""
    n3, bad, m = 15, 6, 4
    u3, rhs, gram = _inputs(n3, r, seed=3)
    gram[bad] -= 50.0 * np.eye(r)
    got = sofia_kernels.mode3_sweep(_t(u3), _t(rhs), _t(gram), LAM1, LAM2, m).numpy()
    assert np.isfinite(got[:bad]).all() and np.isnan(got[bad:]).all()
    with jax.enable_x64(True):
        want = np.asarray(jsofia._mode3_gauss_seidel(jnp.asarray(u3), jnp.asarray(rhs), jnp.asarray(gram),
                                                     LAM1, LAM2, m))
    np.testing.assert_allclose(got[:bad], want[:bad], rtol=1e-12, atol=1e-14)
    assert np.isnan(want[bad]).all()
