"""PyTorch port, the SVT layer (`tritd_tpu_torch/ops/svt.py`) against the JAX
package on the same numpy inputs, float64 on both sides.

Eigen and singular bases are not unique (signs, rotations inside clusters),
so only SVT *outputs* are compared, never factors. The ref-compat `>1` gate
is discontinuous, so every test matrix is built from chosen singular values
that stay away from tau and tau + 1.

Tolerances: route outputs rtol 1e-9 of ||M|| (both sides are float64
LAPACK, in other summation orders); the refined sigma on an ill-conditioned
spectrum (sigma spanning 1e6:1) within sqrt(eps) * sigma_max of the exact
SVT at float32, the JAX package's own bound, and within 1e-12 of ||M|| of
the JAX package's gram output at float64; the randomized route with
JAX's sketch injected rtol 1e-8 (QR and eigh of another LAPACK build); the
refusal messages, `warm_spec`, `auto_method` and the refresh schedule must
be equal.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# `tritd_tpu.ops` exports a function named svt, which hides the module
jsvt = importlib.import_module("tritd_tpu.ops.svt")
from tritd_tpu_torch.ops import svt as tsvt  # noqa: E402

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# shrunk by TAU these give 8, 6, 4.5, 2.5 (kept), 0.4 (kept by svt, cut by
# the >1 gate), and three values below TAU
SPECTRUM = np.array([10.0, 8.0, 6.5, 4.5, 2.4, 1.5, 0.5, 0.1])
TAU = 2.0
SHAPES = [(8, 30), (30, 8), (12, 12), (9, 8)]


def _matrix(shape, spectrum=SPECTRUM, seed=0):
    rng = np.random.default_rng(seed)
    p, q = shape
    k = min(p, q)
    u = np.linalg.qr(rng.standard_normal((p, k)))[0]
    v = np.linalg.qr(rng.standard_normal((q, k)))[0]
    s = np.zeros(k)
    s[: min(k, len(spectrum))] = spectrum[:k]
    return (u * s) @ v.T


def _jax(fn, m, *args, **kwargs):
    with jax.enable_x64(True):
        out = fn(jnp.asarray(m), *args, **kwargs)
        return jax.tree_util.tree_map(np.asarray, out)


def _close(got, want, m, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.linalg.norm(m))


@pytest.mark.parametrize("method", ["svd", "gram", "auto", "auto:4"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", ["svt", "svt_ref_compat"])
def test_routes_match_jax(name, shape, method):
    m = _matrix(shape)
    got = getattr(tsvt, name)(torch.from_numpy(m), TAU, method=method).numpy()
    want = _jax(getattr(jsvt, name), m, TAU, method=method)
    assert got.shape == want.shape == shape
    _close(got, want, m)
    # and the operator itself: rank = number of survivors
    keep = SPECTRUM[: min(shape)] - TAU > (1.0 if name == "svt_ref_compat" else 0.0)
    assert np.linalg.matrix_rank(got, tol=1e-8) == int(keep.sum())


def test_tau_may_be_a_tensor():
    m = torch.from_numpy(_matrix((8, 30)))
    for fn in (tsvt.svt, tsvt.svt_ref_compat):
        torch.testing.assert_close(fn(m, torch.tensor(TAU, dtype=m.dtype), "gram"), fn(m, TAU, "gram"),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(60, 200), (200, 60)], ids=str)
def test_gram_refined_sigma_on_an_ill_conditioned_spectrum(shape):
    """As the JAX package's own test: float32, sigma spanning 1e6:1, tau so
    small that tiny singular triplets are kept. With sigma refined from the
    projection's norms the reconstruction stays within sqrt(eps) * sigma_max
    of the exact SVT (the documented subspace-cluster bound). At float64 the
    port's gram output equals the JAX package's within 1e-12 of ||M||."""
    k = min(shape)
    m = _matrix(shape, np.logspace(0, -6, k))
    bound = float(np.sqrt(np.finfo(np.float32).eps))  # * sigma_max (= 1)
    for tau in (1e-4, 1e-2):
        exact = tsvt.svt(torch.from_numpy(m), tau, "svd").numpy()
        got = tsvt.svt(torch.from_numpy(m).float(), tau, "gram").numpy()
        assert np.abs(got - exact).max() < bound, tau
        got64 = tsvt.svt(torch.from_numpy(m), tau, "gram").numpy()
        _close(got64, _jax(jsvt.svt, m, tau, method="gram"), m, rtol=1e-12)
        _close(got64, exact, m, rtol=1e-12)


@pytest.mark.parametrize("shape", [(20, 60), (60, 20)], ids=str)
def test_lowrank_with_the_reference_sketch(shape):
    """The randomized route, fed the sketch the JAX package draws for this
    shape, gives the JAX output; with its own sketch it gives the exact
    operator, since the five survivors fit the budget of 8."""
    m = _matrix(shape)
    p, q = min(shape), max(shape)
    with jax.enable_x64(True):
        key = jax.random.fold_in(jax.random.PRNGKey(20260821), p * 131071 + q)
        omega = np.array(jax.random.normal(key, (q, 8), jnp.float64))
    want = _jax(jsvt.svt_ref_compat, m, TAU, method="lowrank:8")
    tm = torch.from_numpy(m)
    got = tsvt._lowrank_apply(tm, tsvt._ref_compat_shrink(TAU), 8, omega=torch.from_numpy(omega)).numpy()
    _close(got, want, m, rtol=1e-8)
    exact = tsvt.svt_ref_compat(tm, TAU, "svd").numpy()
    for method in ("lowrank:8", "lowrank", "auto:8"):
        own = tsvt.svt_ref_compat(tm, TAU, method)
        if method == "auto:8":  # thin side 20 < LOWRANK_MIN_DIM: the gram route
            assert tsvt.auto_method(*shape, budget=8) == "gram"
        _close(own.numpy(), exact, m, rtol=1e-8)
    # the sketch is a function of the shape alone: runs repeat
    again = tsvt.svt_ref_compat(tm, TAU, "lowrank:8")
    assert torch.equal(again, tsvt.svt_ref_compat(tm, TAU, "lowrank:8"))
    sk = tsvt.lowrank_sketch(p, q, 8, torch.float64, "cpu")
    assert sk.shape == (q, 8) and torch.equal(sk, tsvt.lowrank_sketch(p, q, 8, torch.float64, "cpu"))


@pytest.mark.parametrize("method", ["lowrank", "lowrank:4", "nope", "warm:4"])
def test_refusals_carry_the_reference_messages(method):
    m = _matrix((8, 30))
    with pytest.raises(ValueError) as want:
        _jax(jsvt.svt, m, TAU, method=method)
    with pytest.raises(ValueError) as got:
        tsvt.svt(torch.from_numpy(m), TAU, method=method)
    assert str(got.value) == str(want.value)


def test_plain_svt_refuses_auto_only_where_it_means_lowrank(monkeypatch):
    """'auto' on a plain SVT is fine while it resolves to gram and refused
    once the thin side reaches LOWRANK_MIN_DIM (lowered here to keep the
    matrix small)."""
    m = torch.from_numpy(_matrix((8, 30)))
    assert tsvt.LOWRANK_MIN_DIM == jsvt.LOWRANK_MIN_DIM == 2048
    tsvt.svt(m, TAU, "auto")
    monkeypatch.setattr(tsvt, "LOWRANK_MIN_DIM", 8)
    with pytest.raises(ValueError, match="only valid for tail-truncating"):
        tsvt.svt(m, TAU, "auto")
    tsvt.svt_ref_compat(m, TAU, "auto:4")


@pytest.mark.parametrize("spec", ["warm8", "warm:", "warm:0", "warm:x", "warm:-2", "warm:2.5", "gram", "Warm:4"])
def test_warm_spec_is_strict(spec):
    shapes = [(200, 300), (50, 1000)]
    with pytest.raises(ValueError) as want:
        jsvt.warm_spec(spec, shapes)
    with pytest.raises(ValueError) as got:
        tsvt.warm_spec(spec, shapes)
    assert str(got.value) == str(want.value)


def test_warm_spec_auto_method_and_constants_equal_jax():
    for name in ("LOWRANK_MIN_DIM", "LOWRANK_BUDGET", "WARM_MIN_DIM"):
        assert getattr(tsvt, name) == getattr(jsvt, name)
    sides = (1, 23, 127, 128, 129, 500, 2016, 2047, 2048, 4800, 6400, 50000)
    for p in sides:
        for q in sides:
            assert tsvt.auto_method(p, q) == jsvt.auto_method(p, q)
            assert tsvt.auto_method(p, q, budget=512) == jsvt.auto_method(p, q, budget=512)
    grids = [[(100, 50000), (10000, 500)], [(10000, 500), (5000, 1000), (1000, 5000)],
             [(23, 46368), (529, 2016)], [(128, 128), (127, 4000), (4000, 129)], []]
    for shapes in grids:
        for spec in ("warm", "warm:1", "warm:8", "warm:32"):
            assert tsvt.warm_spec(spec, shapes) == jsvt.warm_spec(spec, shapes)


@pytest.mark.parametrize("k0", [0, 25])
@pytest.mark.parametrize("n_steps, period", [(25, 8), (25, 16), (7, 4), (8, 8), (3, 1)])
def test_refresh_schedule_matches_jax(n_steps, period, k0):
    """Which absolute iterations refresh: a recording body goes through the
    JAX `run_warm_blocks` (1 = refreshed, 2 = stale, 0 = never visited) and
    through the port's."""
    def jbody(k, sched, refresh):
        return sched.at[k].set(1 if refresh else 2)

    want = np.asarray(jsvt.run_warm_blocks(jbody, jnp.zeros(k0 + n_steps, jnp.int32),
                                           jnp.asarray(k0, jnp.int32), n_steps, period))
    seen = []

    def tbody(k, carry, refresh):
        seen.append((k, refresh))
        return carry + 1

    assert tsvt.run_warm_blocks(tbody, 0, k0, n_steps, period) == n_steps
    got = np.zeros(k0 + n_steps, np.int32)
    for k, refresh in seen:
        assert got[k] == 0 and isinstance(refresh, bool)
        got[k] = 1 if refresh else 2
    np.testing.assert_array_equal(got, want)
    assert [k for k, _ in seen] == list(range(k0, k0 + n_steps))
    # counted from the block's start, not from the absolute iteration
    assert [k - k0 for k, r in seen if r] == list(range(0, n_steps, period))


@pytest.mark.parametrize("shape", [(30, 8), (8, 30), (12, 12)], ids=str)
@pytest.mark.parametrize("name, exact", [("svt_warm", "svt"), ("svt_ref_compat_warm", "svt_ref_compat")])
def test_warm_routes_match_jax(name, exact, shape):
    """A refresh is the gram route; a stale step (the basis of a nearby
    matrix, the same array on both sides) equals the JAX package's."""
    m0 = _matrix(shape)
    m1 = m0 + 0.05 * _matrix(shape, seed=1)
    k = min(shape)
    eye = np.eye(k)
    out0, basis = getattr(tsvt, name)(torch.from_numpy(m0), TAU, torch.from_numpy(eye), True)
    jout0, jbasis = _jax(getattr(jsvt, name), m0, TAU, eye, True)
    assert basis.shape == jbasis.shape == (k, k)
    _close(out0.numpy(), jout0, m0)
    _close(out0.numpy(), getattr(tsvt, exact)(torch.from_numpy(m0), TAU, "gram").numpy(), m0)
    out1, kept = getattr(tsvt, name)(torch.from_numpy(m1), TAU, torch.from_numpy(np.array(jbasis)), False)
    jout1, _ = _jax(getattr(jsvt, name), m1, TAU, jbasis, False)
    assert torch.equal(kept, torch.from_numpy(np.array(jbasis)))
    _close(out1.numpy(), jout1, m1)
    # the stale step is near the exact operator, not equal to it
    err = np.linalg.norm(out1.numpy() - _jax(getattr(jsvt, exact), m1, TAU, method="svd")) / np.linalg.norm(m1)
    assert 0.0 < err < 0.05


def test_float32_stays_float32_and_agrees_with_float64():
    m = _matrix((8, 30))
    want = tsvt.svt_ref_compat(torch.from_numpy(m), TAU, "svd").numpy()
    for method in ("svd", "gram", "lowrank:6"):
        got = tsvt.svt_ref_compat(torch.from_numpy(m).float(), TAU, method)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.linalg.norm(m))
