"""PyTorch port, the other first-party solvers and ops: tritd_admm_outlier,
tritd_als and tritd_mals held against the JAX package from the JAX-drawn
init, and the explicit-Kronecker designs and shrinkage extras against
theirs.

Tolerances: err_hist at float64 rtol 1e-8 (the same programs up to
summation order; as test_torch_admm.py); kron_* and the elementwise
operators exact at float64 (the same operations in the same order), except
lp_reweight at rtol 5e-16: its pow comes from another math library, which
rounds the last bit otherwise now and then.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu.solvers import OutlierConfig as JOutlierConfig  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers import tritd_admm_outlier as j_outlier  # noqa: E402
from tritd_tpu.solvers import tritd_als as j_als  # noqa: E402
from tritd_tpu.solvers import tritd_mals as j_mals  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu_torch.ops import designs, shrinkage  # noqa: E402
from tritd_tpu_torch.solvers import OutlierConfig, TriTDConfig, tritd_admm_outlier, tritd_als, tritd_mals  # noqa: E402

jdesigns = importlib.import_module("tritd_tpu.ops.designs")
jshrink = importlib.import_module("tritd_tpu.ops.shrinkage")

SHAPE = (12, 10, 14)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lowrank(seed, rank=2, spikes=0.0):
    rng = np.random.default_rng(seed)
    a, b, c = (rng.standard_normal(s) for s in ((12, rank, rank), (rank, 10, rank), (rank, rank, 14)))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = 10.0 * x / np.sqrt(np.mean(x**2)) + 0.05 * rng.standard_normal(SHAPE)
    return x + (rng.random(SHAPE) < spikes) * 30.0


def _jax_init(rank):
    return [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, rank, jnp.float64)]


def _compare(res, jres):
    n = int(jres.n_iters)
    assert res.n_iters == n > 2
    want = np.asarray(jres.err_hist)
    got = res.err_hist.numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.isnan(got[n:]).all() and np.isnan(want[n:]).all()
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-8)
    np.testing.assert_allclose(res.rre_hist.numpy()[:n], np.asarray(jres.rre_hist)[:n], rtol=1e-8)
    for f in ("a", "b", "c", "o"):
        w = np.asarray(getattr(jres, f))
        np.testing.assert_allclose(getattr(res, f).numpy(), w, rtol=1e-6, atol=1e-8 * np.abs(w).max(), err_msg=f)


@pytest.mark.parametrize("cfg_fields", [dict(), dict(max_iter=40, tol=0.0, lambda_l1=0.5)],
                         ids=["defaults", "no_stop"])
def test_outlier_matches_jax_f64(cfg_fields):
    x = _lowrank(0, rank=3, spikes=0.03)
    cfg = OutlierConfig(**{"rank": 3, "dtype": "float64", **cfg_fields})
    with jax.enable_x64(True):
        jres = j_outlier(jnp.asarray(x), JOutlierConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0))
        init = _jax_init(3)
    res = tritd_admm_outlier(torch.from_numpy(x), cfg, init=init)
    _compare(res, jres)
    assert res.e is res.o


@pytest.mark.parametrize("mals", [False, True], ids=["als", "mals"])
def test_als_and_mals_match_jax_f64(mals):
    x = _lowrank(1, rank=2)
    cfg = TriTDConfig(rank=2, max_iter=30, dtype="float64")
    with jax.enable_x64(True):
        jres = (j_mals if mals else j_als)(jnp.asarray(x), JConfig(**dataclasses.asdict(cfg)),
                                           key=jax.random.PRNGKey(0))
        init = _jax_init(2)
    res = (tritd_mals if mals else tritd_als)(torch.from_numpy(x), cfg, init=init)
    _compare(res, jres)
    assert not res.o.any() and res.e.shape == SHAPE
    if mals:  # the repaired MALS never stops early
        assert res.n_iters == cfg.max_iter


def test_als_records_the_incoming_error_first():
    """ALS's errHist[0] is the error of the initial factors (errHist ordering
    of `triple_decomp_ALS.m:16-38`); MALS's is after the first sweep."""
    x = _lowrank(2, rank=2)
    cfg = TriTDConfig(rank=2, max_iter=3, dtype="float64", tol=0.0)
    init = [np.random.default_rng(9).standard_normal(s) for s in ((12, 2, 2), (2, 10, 2), (2, 2, 14))]
    l0 = designs.triple_product(*(torch.from_numpy(u) for u in init))
    x_t = torch.from_numpy(x)
    e0 = float(torch.linalg.vector_norm(x_t - l0) / torch.linalg.vector_norm(x_t))
    als = tritd_als(x_t, cfg, init=init)
    mals = tritd_mals(x_t, cfg, init=init)
    assert float(als.err_hist[0]) == pytest.approx(e0, rel=1e-12)
    assert float(mals.err_hist[0]) == pytest.approx(float(als.err_hist[1]), rel=1e-12)


def test_solvers_default_init_is_seeded():
    x = torch.from_numpy(_lowrank(3, rank=2)).float()
    cfg = TriTDConfig(rank=2, max_iter=3)
    r1 = tritd_als(x, cfg)
    r2 = tritd_als(x, cfg, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(r1.a, r2.a, rtol=0, atol=0)
    o1 = tritd_admm_outlier(x, OutlierConfig(rank=2, max_iter=3))
    assert o1.n_iters == 3 and torch.isfinite(o1.err_hist).all()


@pytest.mark.parametrize("name", ["kron_f", "kron_g", "kron_h"])
def test_kron_designs_match_jax_and_build(name):
    rng = np.random.default_rng(4)
    r = 3
    a, b, c = (rng.standard_normal(s) for s in ((7, r, r), (r, 8, r), (r, r, 9)))
    args = {"kron_f": (b, c), "kron_g": (a, c), "kron_h": (a, b)}[name]
    with jax.enable_x64(True):
        want = np.asarray(getattr(jdesigns, name)(*map(jnp.asarray, args)))
    got = getattr(designs, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    build = {"kron_f": designs.build_f, "kron_g": designs.build_g, "kron_h": designs.build_h}[name]
    np.testing.assert_allclose(got, build(*map(torch.from_numpy, args), variant="full").numpy(), rtol=1e-12)


SHRINKAGE = {
    "weighted_soft_threshold": lambda m, x, w: m.weighted_soft_threshold(x, 0.7, w),
    "lp_reweight": lambda m, x, w: m.lp_reweight(x, 1e-3, 0.5, 1.0),
    "prox_l1": lambda m, x, w: m.prox_l1(x, 0.7),
    "huber_clip": lambda m, x, w: m.huber_clip(x),
    "biweight": lambda m, x, w: m.biweight(x),
}


@pytest.mark.parametrize("name", list(SHRINKAGE))
def test_shrinkage_extras_match_jax_exactly(name):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 7, 8)) * 4
    w = rng.random((6, 7, 8)) * 2
    with jax.enable_x64(True):
        want = np.asarray(SHRINKAGE[name](jshrink, jnp.asarray(x), jnp.asarray(w)))
    got = SHRINKAGE[name](shrinkage, torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.dtype == np.float64
    if name == "lp_reweight":
        np.testing.assert_allclose(got, want, rtol=5e-16, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
