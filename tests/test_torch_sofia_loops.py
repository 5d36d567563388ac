"""PyTorch port, SOFIA's device loops (`tritd_tpu_torch/baselines/sofia.py`:
`_Als`, `_Epochs`, `_stream_scan`) and its two kernels' plain versions
(`tritd_tpu_torch/ops/sofia_kernels.py`), on the CPU.

The device form without graphs (`graphs=False`, the route the CPU and the
card's comparison route take) against the JAX package's `sofia_als`,
`sofia_init` and `_stream_scan` on the same numpy float64 inputs, the
draws injected through `u_init`: factors, reconstruction and err_hist rtol
1e-7, stream rtol 1e-9 (the tolerances of `tests/test_torch_sofia.py`).
The ALS stop in the run's dtype, as JAX's float32 loop computes it; the
restart of a kept loop; `_spd_inverse` above r = 3 without a host read; the
plain versions against numpy's pinv (each row within 32 r eps times
the condition of its kept eigenvalues, of the row's scale) and a
row-by-row sweep (rtol 1e-12). The graph route's control flow with a
stand-in CUDA graph (`tests/test_torch_solver_loops.py`'s): its captures
and flag reads, its results bitwise the route without graphs. The card's
cases are in `tests/test_torch_cuda.py`.
"""

import contextlib
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu_torch.ops import hopper_kernels, sofia_kernels  # noqa: E402

jsofia = importlib.import_module("tritd_tpu.baselines.sofia")
sofia = importlib.import_module("tritd_tpu_torch.baselines.sofia")

RTOL = 1e-7
LAM1, LAM2 = 0.1, 0.001


@pytest.fixture(autouse=True)
def _one_torch_thread():
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
    x = np.einsum("ir,jr,tr->ijt", u1, u2, u3) + 0.01 * rng.standard_normal(shape)
    omega = rng.random(shape) > missing
    y = x + np.where(rng.random(shape) < spikes, 8.0, 0.0)
    init = tuple(rng.random((n, r)) for n in shape)
    return x, omega, y, init


# --- the device form without graphs against the JAX package ----------------


@pytest.mark.parametrize("r, m, iters", [(2, 6, 40), (3, 4, 300)])
def test_als_device_form_matches_jax(r, m, iters):
    _x, omega, y, init = _seasonal(r=r, m=m, seed=r)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jsofia.sofia_als(jnp.asarray(y), jnp.asarray(omega), r, m, LAM1, LAM2,
                                                        tuple(jnp.asarray(u) for u in init), max_iters=iters)]
    got = sofia._als_loop(_t(y), _t(omega), *(_t(u) for u in init), m, LAM1, LAM2, iters, 1e-3, graphs=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("m, origin", [(6, True), (1, True), (6, False)])
def test_init_device_form_matches_jax(m, origin):
    x, omega, y, init = _seasonal(m=6, spikes=0.04, seed=2)
    kw = dict(r=2, m=m, lam1=LAM1, lam2=LAM2, lam3=10.0, max_epoch=12, tol=1e-5)
    with jax.enable_x64(True):
        (_, _, ju3), jx, jo, jhist = jsofia.sofia_init(jnp.asarray(y), jnp.asarray(omega),
                                                       origin=jnp.asarray(x) if origin else None, u_init=init,
                                                       dtype=jnp.float64, **kw)
        ju3, jx, jo = np.asarray(ju3), np.asarray(jx), np.asarray(jo)
    (_, _, u3), xh, o, hist = sofia._init_run(_t(y), _t(omega), 2, m, LAM1, LAM2, 10.0, _t(x) if origin else None,
                                              12, 1e-5, 300, None, init, graphs=False)
    assert hist.shape == jhist.shape
    np.testing.assert_allclose(hist, jhist, rtol=RTOL)
    for a, b in ((u3, ju3), (xh, jx), (o, jo)):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("m, need_outlier", [(6, True), (1, True), (4, False)])
def test_stream_device_form_matches_the_jax_scan(m, need_outlier):
    rng = np.random.default_rng(10 + m)
    n1, n2, r, frames = 6, 5, 2, 13
    u1, u2 = rng.random((n1, r)) + 0.1, rng.random((n2, r)) + 0.1
    w_ring, ss_ring = rng.standard_normal((m, r)) + 2.0, 0.3 * rng.standard_normal((m, r))
    l_last, b_last = rng.standard_normal(r) + 2.0, 0.05 * rng.standard_normal(r)
    fs = np.array([[0.3, 0.2], [0.1, 0.05], [0.2, 0.4]])
    y_tail = np.einsum("ir,jr,tr->tij", u1, u2, 2.0 + rng.random((frames, r)))
    y_tail[3, 1, 2] += 6.0
    omega_tail = (rng.random((frames, n1, n2)) > 0.1).astype(np.float64)
    args = (y_tail * omega_tail, omega_tail, u1, u2, w_ring, l_last, b_last, ss_ring, fs, 0.1 * np.ones((n1, n2)))
    hyper = (m, LAM1, LAM2, 0.2, 0.05, need_outlier)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jsofia._stream_scan(*(jnp.asarray(a) for a in args), *hyper)]
    got = sofia._stream_scan(*(_t(a) for a in args), *hyper, False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12)


# --- the stop rule, the restart, the inverses --------------------------------


def test_the_als_stop_is_taken_in_the_runs_dtype():
    """The reference's float32 loop compares |fit - fit_new| with the
    tolerance rounded to float32. A change d just below a tolerance that
    rounds to d itself stops a comparison in double and not the float32
    one: the device's rule stops where JAX's float32 loop stops."""
    f = np.float32
    fit = f(0.75)
    d = f(16777 * 2.0**-24)  # about 1e-3, exact in float32 and as a difference of fits near 0.75
    fit_new = f(fit - d)
    tol = float(d) + 1e-12  # rounds to d in float32
    assert float(fit) - float(fit_new) == float(d) and f(tol) == d
    k = torch.tensor(3)
    got = sofia._fit_stop(k, torch.tensor(fit), torch.tensor(fit_new), tol)
    want = bool((jnp.abs(jnp.float32(fit) - jnp.float32(fit_new)) < tol) & (jnp.int32(3) >= 1))
    assert bool(got) == want is False
    assert abs(float(fit) - float(fit_new)) < tol  # the host's double rule would have stopped
    # in float64 the same fits stop, as the reference's float64 loop does
    f64 = dict(dtype=torch.float64)
    assert bool(sofia._fit_stop(k, torch.tensor(float(fit), **f64), torch.tensor(float(fit_new), **f64), tol))
    assert not bool(sofia._fit_stop(torch.tensor(0), torch.tensor(fit), torch.tensor(fit), 1e-3))  # never at k = 0


def test_a_kept_loop_restarts_as_a_new_one():
    """Started anew from the factors it ended with, a kept loop resets its
    counter and flag and runs the iterations a new loop from those factors
    runs, to the same bits."""
    _x, omega, y, init = _seasonal(seed=4)
    yt, om = _t(y), _t(omega)
    kept = sofia._Als(om, tuple(_t(u) for u in init), 6, LAM1, LAM2, 300, 1e-3, graphs=False)
    kept.start(lambda: yt)
    first = kept.run()
    assert 2 <= first < 300 and bool(kept.carry["done"]) and int(kept.carry["k"]) == first
    ends = tuple(kept.carry[f].clone() for f in ("u1", "u2", "u3"))
    kept.start(lambda: yt * 0.5)
    assert int(kept.carry["k"]) == 0 and not bool(kept.carry["done"]) and kept.loop.k == 0
    second = kept.run()
    fresh = sofia._Als(om, ends, 6, LAM1, LAM2, 300, 1e-3, graphs=False)
    fresh.start(lambda: yt * 0.5)
    assert second == fresh.run() == int(kept.carry["k"])
    for f in ("u1", "u2", "u3", "fit", "done"):
        assert torch.equal(kept.carry[f], fresh.carry[f]), f
    kept.check(kept.carry["k"], second)
    with pytest.raises(AssertionError, match="counter"):
        kept.check(kept.carry["k"], second + 1)


@pytest.mark.parametrize("r", [4, 5])
def test_spd_inverse_above_three_reads_nothing_back_and_turns_nan(r, monkeypatch):
    rng = np.random.default_rng(r)
    g = rng.standard_normal((9, r, r))
    mats = _t(np.einsum("tij,tkj->tik", g, g) + 0.3 * np.eye(r))
    before = torch.cholesky_inverse(torch.linalg.cholesky(mats))  # the form it had, whose cholesky checks `info`

    def no_host_check(*a, **k):
        raise AssertionError("torch.linalg.cholesky reads its info back to the host")

    monkeypatch.setattr(torch.linalg, "cholesky", no_host_check)
    got = sofia._spd_inverse(mats)
    assert torch.equal(got, before)
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(mats.numpy()), rtol=1e-9, atol=1e-12)
    bad = mats.clone()
    bad[2] -= 100.0 * torch.eye(r, dtype=torch.float64)  # not positive definite
    out = sofia._spd_inverse(bad)
    assert torch.isnan(out[2]).all() and torch.equal(out[[0, 1, *range(3, 9)]], before[[0, 1, *range(3, 9)]])


# --- the kernels' plain versions ---------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 3, 8])
def test_pinv_rows_plain_version_matches_numpy(r, dtype):
    rng = np.random.default_rng(r)
    a = rng.standard_normal((12, r, r))
    gram = np.einsum("nij,nkj->nik", a, a)
    gram[0] = 0.0  # an all-missing slice
    gram[1] = np.outer(a[1, 0], a[1, 0])  # rank one
    rhs = rng.standard_normal((12, r))
    rtol = 10.0 * r * torch.finfo(dtype).eps
    rhs_t, gram_t = _t(rhs).to(dtype), _t(gram).to(dtype)
    got = sofia_kernels.pinv_rows(rhs_t, gram_t, rtol)
    # numpy's pinv in float64 of the inputs as rounded, with the same cut-off
    g64 = gram_t.double().numpy()
    want = np.einsum("ni,nij->nj", rhs_t.double().numpy(), np.linalg.pinv(g64, rcond=rtol))
    assert torch.equal(got[0], torch.zeros(r, dtype=dtype))
    # each row within 32 r eps of its scale times the condition of what its gram keeps
    lam = np.abs(np.linalg.eigvalsh(g64))
    kept = np.where(lam > rtol * lam.max(axis=1, keepdims=True), lam, np.inf)
    cond = lam.max(axis=1) / np.maximum(kept.min(axis=1), 1e-300)
    tol = 32 * r * torch.finfo(dtype).eps * np.where(np.isfinite(cond), cond, 1.0)
    scale = np.abs(want).max(axis=1)
    assert np.all(np.abs(got.double().numpy() - want).max(axis=1) <= tol * scale)


@pytest.mark.parametrize("n3, r, m", [(40, 3, 7), (25, 2, 1), (10, 4, 12)])
def test_gauss_seidel_sweep_plain_version_is_the_row_recurrence(n3, r, m):
    rng = np.random.default_rng(n3)
    rhs0 = rng.standard_normal((n3, r))
    a = rng.standard_normal((n3, r, r))
    inv = np.linalg.inv(np.einsum("tij,tkj->tik", a, a) + 2.0 * np.eye(r))
    got = sofia_kernels.gauss_seidel_sweep(_t(rhs0), _t(inv), 0.3, 0.2, m).numpy()
    want = np.zeros((n3, r))
    for t in range(n3):
        row = rhs0[t].copy()
        if t > 0:
            row += 0.3 * want[t - 1]
        if t >= m:
            row += 0.2 * want[t - m]
        want[t] = row @ inv[t]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="at least 1"):
        sofia_kernels.gauss_seidel_sweep(_t(rhs0), _t(inv), 0.3, 0.2, 0)


def test_the_kernels_name_their_rank_limit():
    for r in (sofia_kernels.MAX_RANK + 1, 40):
        rhs, gram = torch.zeros(2, r), torch.zeros(2, r, r)
        with pytest.raises(ValueError, match=f"ranks 1 to {sofia_kernels.MAX_RANK}"):
            sofia_kernels._check("pinv_rows", (rhs, gram), ((2, r), (2, r, r)))
    assert sofia_kernels.MAX_RANK >= 32
    with pytest.raises(TypeError, match="float32 or float64"):
        sofia_kernels._check("pinv_rows", (torch.zeros(2, 3, dtype=torch.float16),), ((2, 3),))
    with pytest.raises(ValueError, match="contiguous"):
        sofia_kernels._check("gauss_seidel_sweep", (torch.zeros(3, 2).T,), ((3, 2),))


def test_the_graph_route_is_the_cards_for_ranks_up_to_three():
    """Since the mode-3 step is one kernel launch, the card's route is the
    graphs' at every rank the kernels take, up to MAX_RANK (the name keeps
    the limit it had when torch's batched Cholesky inverted ranks above
    three); never on the CPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert all(sofia._graph_route(cuda, r) for r in range(1, sofia_kernels.MAX_RANK + 1))
    assert not sofia._graph_route(cuda, sofia_kernels.MAX_RANK + 1)
    assert not any(sofia._graph_route(cpu, r) for r in (1, 3, 4, sofia_kernels.MAX_RANK))


# --- the graph route's control flow with a stand-in CUDA graph ---------------


class _FakeGraph:
    """Stands in for `hopper_kernels.CountedGraph`: the capture records the
    program, each replay runs it."""

    captures: list = []

    def __init__(self, fn, pool, tallies=()):
        self.fn = fn
        _FakeGraph.captures.append(fn)

    def replay(self):
        self.fn()


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(hopper_kernels, "CountedGraph", _FakeGraph)
    _FakeGraph.captures = []
    return _FakeGraph.captures


def _same(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("max_epoch", [1, 2, 6])
def test_init_graph_route_captures_three_programs_a_call(fake_graphs, monkeypatch, max_epoch):
    """The ALS start, an ALS iteration and the epoch step: each run eagerly
    at its first use and captured at its second, three captures at most a
    call, whatever the epochs; one ALS flag read an iteration short of the
    cap; the result the route without graphs gives, bitwise."""
    x, omega, y, init = _seasonal(m=6, spikes=0.04, seed=2)
    reads = []
    real = sofia._AlsLoop._read_flags
    monkeypatch.setattr(sofia._AlsLoop, "_read_flags", lambda self: reads.append(1) or real(self))
    args = (_t(y).float(), _t(omega), 2, 6, LAM1, LAM2, 10.0, _t(x).float(), max_epoch, 0.0, 300, None, init)
    graphs = sofia._init_run(*args, graphs=True)
    assert len(fake_graphs) == (1 if max_epoch == 1 else 3)
    n_reads = len(reads)
    eager = sofia._init_run(*args, graphs=False)
    assert _same(graphs, eager)
    assert n_reads == len(reads) - n_reads > 0


def test_als_and_stream_graph_routes_capture_one_program(fake_graphs):
    x, omega, y, init = _seasonal(seed=6)
    args = (_t(y).float(), _t(omega), *(_t(u).float() for u in init), 6, LAM1, LAM2, 50, 1e-3)
    graphs = sofia._als_loop(*args, graphs=True)
    assert len(fake_graphs) == 1
    assert _same(graphs, sofia._als_loop(*args, graphs=False))
    rng = np.random.default_rng(1)
    n1, n2, r, m, frames = 5, 4, 2, 3, 9
    stream = tuple(_t(a).float() for a in (
        rng.random((frames, n1, n2)), np.ones((frames, n1, n2)), rng.random((n1, r)), rng.random((n2, r)),
        rng.random((m, r)) + 1, rng.random(r) + 1, 0.01 * rng.random(r), 0.1 * rng.random((m, r)),
        np.full((3, r), 0.2), np.full((n1, n2), 0.1)))
    del fake_graphs[:]
    got = sofia._stream_scan(*stream, m, LAM1, LAM2, 0.1, 0.05, True, True)
    assert len(fake_graphs) == 1
    assert _same(tuple(got), tuple(sofia._stream_scan(*stream, m, LAM1, LAM2, 0.1, 0.05, True, False)))
