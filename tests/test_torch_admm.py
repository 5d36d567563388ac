"""PyTorch port, whole solver: tritd_tpu_torch.tritd_admm held against the
JAX tritd_admm (same numpy data, the JAX-drawn init carried over through
tritd_tpu_torch.interop), against the MATLAB golden two-iteration literals,
and against the float64 MATLAB-semantics emulator.

Tolerances, with reasons:
  * float64 vs JAX float64: rtol 1e-8 on err_hist/rre_hist over the whole
    run — both are exact-arithmetic-equal programs; only summation order
    differs, and ADMM damps rather than amplifies those ulps.
  * float32 vs JAX float32: rtol 2e-4 on the first 20 iterations — f32
    rounding in the solves drifts apart as mu grows toward its cap.
  * golden: rtol 1e-9 / atol 1e-10, as test_golden.py.
  * emulator: max |diff| < 1e-10 on err_hist, as test_emulator_parity.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_golden import ADMM_E, ADMM_ERRS, ADMM_L, ADMM_O, _fixture_cores  # noqa: E402
from tritd_tpu_torch.oracle import tritd_admm_em  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers import init_state as j_init_state  # noqa: E402
from tritd_tpu.solvers import tritd_admm as j_tritd_admm  # noqa: E402
from tritd_tpu.solvers.admm import admm_iteration as j_admm_iteration  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu_torch import interop  # noqa: E402
from tritd_tpu_torch.ops.designs import triple_product  # noqa: E402
from tritd_tpu_torch.solvers import (  # noqa: E402
    TriTDConfig,
    admm_iteration,
    init_state,
    trim_history,
    tritd_admm,
)
from tritd_tpu_torch.utils.config import COMPLETION_TRITD  # noqa: E402

SHAPE = (12, 10, 14)
RANK = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=0, missing=0.1):
    """Low-TriTD-rank truth + noise + sparse spikes, 10% missing, zero-filled."""
    rng = np.random.default_rng(seed)
    n1, n2, n3 = SHAPE
    a = rng.standard_normal((n1, RANK, RANK))
    b = rng.standard_normal((RANK, n2, RANK))
    c = rng.standard_normal((RANK, RANK, n3))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = 10.0 * x / np.sqrt(np.mean(x**2)) + 0.1 * rng.standard_normal(SHAPE)
    x = x + (rng.random(SHAPE) < 0.02) * 20.0
    mask = np.ones(x.size, bool)
    mask[rng.permutation(x.size)[: int(round(missing * x.size))]] = False
    mask = mask.reshape(SHAPE)
    return x, np.where(mask, x, 0.0), mask


def _jax_init(dtype):
    return [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, RANK, dtype)]


def _run_both(cfg, masked, x64):
    x, y, mask = _problem()
    np_dt = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        jcfg = JConfig(**dataclasses.asdict(cfg))
        init = _jax_init(jnp.float64 if x64 else jnp.float32)
        jres = j_tritd_admm(
            jnp.asarray(y, np_dt), jcfg, key=jax.random.PRNGKey(0),
            mask=jnp.asarray(mask) if masked else None, origin=jnp.asarray(x, np_dt),
        )
        jres = {f: np.asarray(getattr(jres, f)) for f in jres._fields}
    res = tritd_admm(
        torch.from_numpy(y.astype(np_dt)), cfg,
        mask=torch.from_numpy(mask) if masked else None,
        origin=torch.from_numpy(x.astype(np_dt)), init=init,
    )
    return interop.result_to_numpy(res), jres


F64_CASES = {
    "unmasked": (dict(), False),
    "masked_origin": (dict(masked=True), True),
    "unroll3": (dict(unroll=3, max_iter=40), False),
}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_tritd_admm_matches_jax_f64(case):
    overrides, masked = F64_CASES[case]
    cfg = dataclasses.replace(COMPLETION_TRITD, **{"rank": RANK, "dtype": "float64", "max_iter": 60, **overrides})
    got, want = _run_both(cfg, masked, x64=True)
    n = int(want["n_iters"])
    assert got["n_iters"] == n > 2
    for key in ("err_hist", "rre_hist"):
        assert got[key].shape == (cfg.max_iter,)
        assert np.isnan(got[key][n:]).all() and np.isnan(want[key][n:]).all()
        np.testing.assert_allclose(got[key][:n], want[key][:n], rtol=1e-8)
    for key in ("a", "b", "c", "o", "e"):
        assert got[key].dtype == np.float64
    np.testing.assert_allclose(got["o"], want["o"], rtol=1e-6, atol=1e-8 * np.abs(want["o"]).max())


def test_tritd_admm_matches_jax_f32():
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=20, tol=0.0)
    got, want = _run_both(cfg, masked=False, x64=False)
    assert got["n_iters"] == int(want["n_iters"]) == 20
    assert got["err_hist"].dtype == np.float32
    np.testing.assert_allclose(got["err_hist"], want["err_hist"], rtol=2e-4)
    np.testing.assert_allclose(got["rre_hist"], want["rre_hist"], rtol=2e-4)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_admm_iteration_from_jax_state(masked):
    """One iteration started from the reference's own state (carried over by
    interop.state_from_numpy) lands on the reference's next state."""
    x, y, mask = _problem(1)
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, dtype="float64", masked=masked)
    with jax.enable_x64(True):
        jd, jmask = jnp.asarray(y), jnp.asarray(mask) if masked else None
        s = j_init_state(jd, JConfig(**dataclasses.asdict(cfg)), jax.random.PRNGKey(3))
        for _ in range(3):
            s = j_admm_iteration(jd, s, JConfig(**dataclasses.asdict(cfg)), mask=jmask)
        start = {f: np.asarray(getattr(s, f)) for f in s._fields}
        s = j_admm_iteration(jd, s, JConfig(**dataclasses.asdict(cfg)), mask=jmask)
        want = {f: np.asarray(getattr(s, f)) for f in s._fields}
    state = interop.state_from_numpy(start)
    assert state.k == 3 and state.mu_l.dtype == np.float64
    got = admm_iteration(torch.from_numpy(y), state, cfg,
                         mask=torch.from_numpy(mask) if masked else None)
    assert got.k == 4 and got.mu_l == want["mu_l"] and got.mu_o == want["mu_o"]
    assert bool(got.done) == bool(want["done"])
    for f in ("a", "b", "c", "o", "e", "y_l", "y_o", "t", "err_hist"):
        w = want[f]
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-8,
                                   atol=1e-10 * np.nanmax(np.abs(w)), err_msg=f)


def test_two_admm_iterations_match_matlab_golden():
    d = np.zeros((3, 3, 3))
    for i in range(3):
        for j in range(3):
            for t in range(3):
                d[i, j, t] = ((-1) ** (i + j + t)) * (1 + i + 2 * j + 3 * t) + i * j * t
    d = torch.from_numpy(d)
    cfg = TriTDConfig(
        rank=2, max_iter=2, tol=0.0, mu=0.5, rho=1.25, lambda_l1=0.3,
        lambda2=1e-3, solve_method="pinv", dtype="float64",
    )
    state = init_state(d, cfg, _fixture_cores(n1=3, n2=3, n3=3, r=2, scale=0.25))
    for _ in range(2):
        state = admm_iteration(d, state, cfg)
    l = triple_product(state.a, state.b, state.c)
    np.testing.assert_allclose(l.numpy(), ADMM_L, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(state.o.numpy(), ADMM_O, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(state.e.numpy(), ADMM_E, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(state.err_hist[:2].numpy(), ADMM_ERRS, rtol=1e-9)


def test_trajectory_matches_matlab_emulator():
    x, y, _mask = _problem(2)
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, dtype="float64", max_iter=30)
    with jax.enable_x64(True):
        a0, b0, c0 = _jax_init(jnp.float64)
    em = tritd_admm_em(
        y, a0, b0, c0, mu=cfg.mu, rho=cfg.rho, lam=cfg.lambda_l1, lam2=cfg.lambda2,
        alpha_c=cfg.alpha_c, max_iter=cfg.max_iter, tol=cfg.tol, origin=x,
    )
    res = tritd_admm(torch.from_numpy(y), cfg, origin=torch.from_numpy(x), init=(a0, b0, c0))
    assert res.n_iters == em["n_iters"]
    got = trim_history(res.err_hist, res.n_iters)
    assert np.abs(got - em["err_hist"]).max() < 1e-10
    assert np.abs(trim_history(res.rre_hist, res.n_iters) - em["rre_hist"]).max() < 1e-10


def test_default_init_is_seeded_and_device_independent():
    _x, y, _mask = _problem()
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=3)
    r1 = tritd_admm(torch.from_numpy(y.astype(np.float32)), cfg)
    r2 = tritd_admm(torch.from_numpy(y.astype(np.float32)), cfg,
                    generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(r1.a, r2.a, rtol=0, atol=0)
    assert r1.n_iters == 3 and torch.isfinite(r1.err_hist).all()


@pytest.mark.parametrize("field", ["einsum_dtype", "storage_dtype"])
def test_unported_options_raise(field):
    """bfloat16, float16 and the two float8 formats are ported
    (tests/test_torch_narrow.py, tests/test_torch_narrow_dtypes.py); a dtype
    no caller uses, such as int8, is refused and the message names the ones
    the port takes."""
    cfg = dataclasses.replace(COMPLETION_TRITD, **{field: "int8"})
    with pytest.raises(NotImplementedError, match="takes None or one of"):
        tritd_admm(torch.zeros(SHAPE), cfg)


def test_mask_guards():
    d = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="requires a mask"):
        tritd_admm(d, TriTDConfig(masked=True))
    with pytest.raises(ValueError, match="masked=False"):
        tritd_admm(d, TriTDConfig(), mask=torch.ones(SHAPE, dtype=torch.bool))


def test_disp_prints_every_tenth_iteration(capsys):
    _x, y, _mask = _problem()
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=20, tol=0.0, disp=True, unroll=4)
    tritd_admm(torch.from_numpy(y), cfg)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Iter")]
    assert [ln.split(",")[0] for ln in lines] == ["Iter 10", "Iter 20"]
