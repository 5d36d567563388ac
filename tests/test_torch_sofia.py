"""PyTorch port, SOFIA (`tritd_tpu_torch/baselines/sofia.py`) against the JAX
package on the same numpy inputs (float64 on both sides), against the numpy
MATLAB emulator, and its streaming steps against its own numpy oracle.

Tolerances: the masked row systems, the batched pinv (with a singular Gram
among them), the SPD closed-form inverse and the Gauss-Seidel sweep rtol
1e-9 against JAX; the sweep rtol 1e-9 against a direct row-wise loop of the
reference recurrence as well. `sofia_als` and `sofia_init` from injected
factors: factors, reconstruction and the whole err_hist rtol 1e-7 against
JAX (ALS carries LAPACK's rounding forward) and atol 1e-8 against the
emulator, with equal numbers of epochs. The Holt-Winters helpers are the
same host numpy and scipy and must be equal. The streaming steps in tensors
against JAX's scan on the same inputs rtol 1e-9 at float64; the float32
device stream against the float64 numpy oracle with the bounds of the JAX
package's own test (rtol 2e-3 on the time factors, 5e-3 of the data's scale
on frames), which measure dtype drift only.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu_torch.oracle import matlab_emulator as em  # noqa: E402

jsofia = importlib.import_module("tritd_tpu.baselines.sofia")
sofia = importlib.import_module("tritd_tpu_torch.baselines.sofia")

RTOL = 1e-7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seasonal(shape=(9, 8, 24), r=2, m=6, seed=0, missing=0.15, spikes=0.0):
    """Seasonal CP tensor with noise: (truth, observed mask, data, init)."""
    rng = np.random.default_rng(seed)
    n1, n2, n3 = shape
    t = np.arange(n3)
    u3 = np.stack([np.sin(2 * np.pi * (t + 3 * k) / m) + 0.05 * t + 2.0 for k in range(r)], axis=1)
    u1, u2 = rng.random((n1, r)) + 0.2, rng.random((n2, r)) + 0.2
    x = np.einsum("ir,jr,tr->ijt", u1, u2, u3)
    x = x + 0.01 * rng.standard_normal(shape)
    omega = rng.random(shape) > missing
    y = x + np.where(rng.random(shape) < spikes, 8.0, 0.0)
    init = tuple(rng.random((n, r)) for n in shape)
    return x, omega, y, init


def _jax64(fn, *args, **kwargs):
    """fn on numpy inputs, which become float64 JAX arrays only inside the
    x64 scope (outside it jnp.asarray would round them to float32)."""
    with jax.enable_x64(True):
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kwargs)
        return jax.tree_util.tree_map(np.asarray, out)


def test_masked_row_systems_and_pinv_rows_match_jax():
    rng = np.random.default_rng(1)
    y = rng.standard_normal((5, 6, 7))
    omega = (rng.random((5, 6, 7)) > 0.3).astype(np.float64)
    omega[2] = 0.0  # an all-missing slice: its Gram is singular (zero)
    omega[3, :, 1:] = 0.0  # rank one
    wkr = rng.standard_normal((6, 7, 3))
    rhs, gram = sofia._masked_row_systems(_t(y * omega), _t(omega), _t(wkr))
    jrhs, jgram = _jax64(jsofia._masked_row_systems, y * omega, omega, wkr)
    np.testing.assert_allclose(rhs.numpy(), jrhs, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gram.numpy(), jgram, rtol=1e-12, atol=1e-12)
    rows = sofia._pinv_rows(rhs, gram)
    jrows = _jax64(jsofia._pinv_rows, jrhs, jgram)
    np.testing.assert_allclose(rows.numpy(), jrows, rtol=1e-9, atol=1e-12)
    assert torch.equal(rows[2], torch.zeros(3, dtype=torch.float64))  # min-norm answer of a zero system
    # the cut-off is the reference's: 10 * r * eps, not torch's r * eps
    g = np.diag([1.0, 1.0, 20 * np.finfo(np.float64).eps])[None]
    got = sofia._pinv_rows(_t(np.ones((1, 3))), _t(g))
    np.testing.assert_allclose(got.numpy(), _jax64(jsofia._pinv_rows, np.ones((1, 3)), g), rtol=1e-12)
    assert float(got[0, 2]) == 0.0 and float(torch.linalg.pinv(_t(g))[0, 2, 2]) > 1e12


@pytest.mark.parametrize("r", [1, 2, 3, 4, 6])
def test_spd_inverse_matches_jax_and_numpy(r):
    rng = np.random.default_rng(r)
    g = rng.standard_normal((11, r, r))
    mats = np.einsum("tij,tkj->tik", g, g) + 0.3 * np.eye(r)
    got = sofia._spd_inverse(_t(mats)).numpy()
    np.testing.assert_allclose(got, np.linalg.inv(mats), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, _jax64(jsofia._spd_inverse, mats), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n3, r, m", [(37, 4, 7), (20, 3, 5), (12, 2, 1), (9, 1, 4), (6, 3, 6)])
def test_gauss_seidel_sweep_matches_rowwise_reference_and_jax(n3, r, m):
    """Row t is solved against the updated rows t-1, t-m and the old rows
    t+1, t+m (`sofia_als.m:100-122`), as a direct per-row loop does."""
    lam1, lam2 = 0.3, 0.15
    rng = np.random.default_rng(n3)
    u3, rhs = rng.standard_normal((n3, r)), rng.standard_normal((n3, r))
    g = rng.standard_normal((n3, r, r))
    gram = np.einsum("tij,tkj->tik", g, g) + 0.5 * np.eye(r)
    got = sofia._mode3_gauss_seidel(_t(u3), _t(rhs), _t(gram), lam1, lam2, m).numpy()

    ref = u3.copy()
    eye = np.eye(r)
    for t in range(n3):
        rr, gg = rhs[t].copy(), gram[t].copy()
        if t > 0:
            rr += lam1 * ref[t - 1]
            gg += lam1 * eye
        if t < n3 - 1:
            rr += lam1 * ref[t + 1]
            gg += lam1 * eye
        if t >= m:
            rr += lam2 * ref[t - m]
            gg += lam2 * eye
        if t < n3 - m:
            rr += lam2 * ref[t + m]
            gg += lam2 * eye
        ref[t] = rr @ np.linalg.pinv(gg)
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    with jax.enable_x64(True):
        want = np.asarray(jsofia._mode3_gauss_seidel(jnp.asarray(u3), jnp.asarray(rhs), jnp.asarray(gram),
                                                     lam1, lam2, m))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("r, m", [(2, 6), (3, 4)])
def test_sofia_als_matches_jax_and_the_emulator(r, m):
    x, omega, y, init = _seasonal(r=r, m=m)
    with jax.enable_x64(True):
        ju1, ju2, ju3, jx = (np.asarray(a) for a in jsofia.sofia_als(
            jnp.asarray(y), jnp.asarray(omega), r, m, 0.1, 0.001, tuple(jnp.asarray(u) for u in init),
            max_iters=40))
    u1, u2, u3, xh = sofia.sofia_als(_t(y), _t(omega), r, m, 0.1, 0.001, init, max_iters=40)
    assert xh.dtype == torch.float64 and xh.shape == y.shape
    for got, want in ((u1, ju1), (u2, ju2), (u3, ju3), (xh, jx)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    want = em.sofia_als_em(y, omega, r, m, 0.1, 0.001, init, max_iters=40)
    np.testing.assert_allclose(xh.numpy(), want["x_hat"], rtol=0, atol=1e-8)
    masked_err = np.linalg.norm(omega * (y - xh.numpy())) / np.linalg.norm(omega * y)
    assert masked_err < 0.05


def test_sofia_als_stops_on_the_fit_change_like_the_emulator():
    _x, omega, y, init = _seasonal()
    calls = []
    orig = sofia._mode3_gauss_seidel

    def counting(*args):
        calls.append(1)
        return orig(*args)

    want = em.sofia_als_em(y, omega, 2, 6, 0.1, 0.001, init, max_iters=300, fitchangetol=1e-3)
    assert 2 <= want["n_iters"] < 300
    sofia._mode3_gauss_seidel = counting
    try:
        xh = sofia.sofia_als(_t(y), _t(omega), 2, 6, 0.1, 0.001, init, max_iters=300, fitchangetol=1e-3)[3]
    finally:
        sofia._mode3_gauss_seidel = orig
    assert len(calls) == want["n_iters"]
    np.testing.assert_allclose(xh.numpy(), want["x_hat"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("m", [6, 1], ids=["traffic", "video_m1"])
def test_sofia_init_matches_jax_and_the_emulator(m):
    x, omega, y, init = _seasonal(m=6, spikes=0.04, seed=2)
    kw = dict(r=2, m=m, lam1=0.1, lam2=0.001, lam3=10.0, max_epoch=12, tol=1e-5)
    with jax.enable_x64(True):
        (ju1, ju2, ju3), jx, jo, jhist = jsofia.sofia_init(
            jnp.asarray(y), jnp.asarray(omega), origin=jnp.asarray(x), u_init=init, dtype=jnp.float64, **kw)
        ju3, jx, jo = np.asarray(ju3), np.asarray(jx), np.asarray(jo)
    (u1, u2, u3), xh, o, hist = sofia.sofia_init(_t(y), _t(omega), origin=_t(x), u_init=init,
                                                 dtype=torch.float64, **kw)
    assert isinstance(hist, np.ndarray) and hist.shape == jhist.shape and hist[-1] < hist[0]
    np.testing.assert_allclose(hist, jhist, rtol=RTOL)
    for got, want in ((u3, ju3), (xh, jx), (o, jo)):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    want = em.sofia_init_em(y, omega, 2, m, 0.1, 0.001, 10.0, init, x, max_epoch=12, tol=1e-5)
    assert want["n_epochs"] == len(hist)
    np.testing.assert_allclose(hist, want["err_hist"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(o.numpy(), want["o"], rtol=0, atol=1e-7)


def test_sofia_init_draws_repeat_and_default_to_float32():
    x, omega, y, _init = _seasonal(seed=3)
    runs = [sofia.sofia_init(y, omega, r=2, m=6, origin=x, max_epoch=3,
                             generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    (u, xh, o, hist), (_u, xh2, _o, hist2) = runs
    assert xh.dtype == o.dtype == u[0].dtype == torch.float32
    assert torch.equal(xh, xh2) and np.array_equal(hist, hist2) and len(hist) == 3
    none = sofia.sofia_init(y, omega, r=2, m=6, max_epoch=2)
    assert none[3].shape == (0,)
    default = sofia.sofia_init(y, omega, r=2, m=6, max_epoch=2)  # seed 0 when no generator is given
    assert torch.equal(none[1], default[1])


def test_holt_winters_helpers_equal_jax():
    m = 6
    t = np.arange(48, dtype=np.float64)
    rng = np.random.default_rng(0)
    w = np.stack([0.5 * t + 3.0 + 2.0 * np.sin(2 * np.pi * t / m),
                  -0.1 * t + np.cos(2 * np.pi * t / m) + 0.05 * rng.standard_normal(48)], axis=1)
    got, want = sofia.hw_fit(w, m), jsofia.hw_fit(w, m)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _, ls, bs, ss, fs = got
    np.testing.assert_array_equal(sofia.hw_forecast(ls, bs, ss, m, h=5), jsofia.hw_forecast(ls, bs, ss, m, h=5))
    new = rng.standard_normal((3, 2))
    for a, b in zip(sofia.hw_update(new, ls, bs, ss, fs, m), jsofia.hw_update(new, ls, bs, ss, fs, m)):
        np.testing.assert_array_equal(a, b)
        assert a.shape[0] == 48 + 3
    x0 = np.concatenate([[0.2, 0.1, 0.3, 1.0, 0.5], w[:m, 0]])
    assert sofia._hw_sse(x0, w[:, 0], m, 1e30) == jsofia._hw_sse(x0, w[:, 0], m, 1e30)
    for bad in ([0.0, 0.1, 0.3], [0.2, 0.3, 0.3], [0.2, 0.1, 0.9]):  # the soft constraints
        xb = np.concatenate([bad, x0[3:]])
        assert sofia._hw_sse(xb, w[:, 0], m, 1e30) == jsofia._hw_sse(xb, w[:, 0], m, 1e30) == 1e30
    for a, b in zip(sofia._hw_predict(x0, w[:, 0], m), jsofia._hw_predict(x0, w[:, 0], m)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sofia._huber(w), jsofia._huber(w))
    np.testing.assert_array_equal(sofia._biweight(w), jsofia._biweight(w))


def test_stream_helpers():
    x = np.arange(24.0).reshape(2, 3, 4)
    frames = list(sofia.tensor2stream(x))
    assert len(frames) == 4 and frames[0].shape == (2, 3)
    assert sofia.compute_nre(x, x) == 0.0 and sofia.compute_rmse(x + 1, x) == 1.0
    assert sofia.compute_nre(x + 1, x) == jsofia.compute_nre(x + 1, x)


@pytest.mark.parametrize("m, need_outlier", [(6, True), (1, True), (4, False)])
def test_stream_steps_match_the_jax_scan(m, need_outlier):
    """The streaming steps on the same state and frames, float64."""
    rng = np.random.default_rng(m)
    n1, n2, r, frames = 7, 6, 2, 15
    u1, u2 = rng.random((n1, r)) + 0.1, rng.random((n2, r)) + 0.1
    w_ring, ss_ring = rng.standard_normal((m, r)) + 2.0, 0.3 * rng.standard_normal((m, r))
    l_last, b_last = rng.standard_normal(r) + 2.0, 0.05 * rng.standard_normal(r)
    fs = np.array([[0.3, 0.2], [0.1, 0.05], [0.2, 0.4]])
    y_tail = np.einsum("ir,jr,tr->tij", u1, u2, 2.0 + rng.random((frames, r)))
    y_tail[4, 2, 3] += 5.0  # an outlier for the Huber clean to catch
    omega_tail = (rng.random((frames, n1, n2)) > 0.1).astype(np.float64)
    sigma0 = 0.1 * np.ones((n1, n2))
    args = (y_tail * omega_tail, omega_tail, u1, u2, w_ring, l_last, b_last, ss_ring, fs, sigma0)
    hyper = (m, 0.1, 0.001, 0.2, 0.05, need_outlier)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jsofia._stream_scan(*(jnp.asarray(a) for a in args), *hyper)]
    got = sofia._stream_scan(*(_t(a) for a in args), *hyper)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12)
    assert bool(got[4].any()) == need_outlier
    # the rings handed in are not written to
    np.testing.assert_array_equal(args[4], w_ring)


def test_sofia_stream_device_matches_numpy_oracle():
    """Same init (shared sofia_init and hw_fit, the same generator seed),
    then float32 tensor steps against the float64 numpy loop."""
    m, cycles = 6, 2
    x, omega, _y, _init = _seasonal(shape=(8, 9, 36), m=m, missing=0.05, seed=5)
    kwargs = dict(r=2, m=m, cycles=cycles, max_epoch=10, mu=0.2)
    (u1n, u2n), wn, xn, on = sofia.sofia_stream(x, omega, generator=torch.Generator().manual_seed(0), **kwargs)
    (u1d, u2d), wd, xd, od = sofia.sofia_stream_device(_t(x), _t(omega), generator=torch.Generator().manual_seed(0),
                                                       **kwargs)
    ti = m * cycles
    assert wn.shape == wd.shape == (36, 2) and xn.shape == xd.shape == x.shape and od.dtype == np.float64
    np.testing.assert_array_equal(wd[:ti], wn[:ti])  # the shared batch init
    np.testing.assert_allclose(wd[ti:], wn[ti:], rtol=2e-3, atol=2e-3)
    scale = np.abs(xn[:, :, ti:]).max()
    np.testing.assert_allclose(xd[:, :, ti:] / scale, xn[:, :, ti:] / scale, atol=5e-3)
    np.testing.assert_allclose(od[:, :, ti:] / scale, on[:, :, ti:] / scale, atol=5e-3)
    np.testing.assert_allclose(u1d, u1n, rtol=2e-3, atol=2e-3)
    # the stream tracks the seasonal data after its warm start
    tail_err = np.linalg.norm(xn[:, :, ti:] - x[:, :, ti:]) / np.linalg.norm(x[:, :, ti:])
    assert np.isfinite(tail_err) and tail_err < 0.8
    # at float64 the tensor steps are the numpy loop up to rounding
    (_, _), w64, x64, _o = sofia.sofia_stream_device(x, omega, generator=torch.Generator().manual_seed(0),
                                                     dtype=torch.float64, need_outlier=False, **kwargs)
    assert _o is None and np.isfinite(w64).all() and np.isfinite(x64).all()
