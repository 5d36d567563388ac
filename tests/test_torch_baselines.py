"""PyTorch port, the comparison baselines (`tritd_tpu_torch/baselines/`)
against the JAX package on the same numpy inputs, float64 on both sides, and
against the numpy MATLAB emulator (`tritd_tpu/oracle/matlab_emulator.py`).

Tolerances: the weight and ordering helpers and the column-major 4-way
split must be equal. Whole `err_hist` trajectories of the SVT baselines
(`tt_trpca`, `rtrc`, `rc_fctn` under both drivers, `trpca_tnn`,
`trpca_snn`) rtol 1e-7 over 15-20 iterations: both sides are float64
LAPACK in other summation orders, and an ADMM carries that rounding
forward; final tensors atol 1e-7 of their norm. The same for a `warm:4` run
with the warm threshold lowered, so that the small unfoldings carry a
basis. `rnc_fctn`, from the factors and padding scalars the JAX package
draws, rtol 1e-7. Against the emulator atol 1e-10 over 30 iterations on a
9x7x24 problem, the bound `tests/test_emulator_parity.py` holds JAX to.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu.oracle import matlab_emulator as em  # noqa: E402
from tritd_tpu_torch.data.loaders import DatasetSpec, synthetic_traffic  # noqa: E402
from tritd_tpu_torch.data.synthetic import uniform_missing_mask  # noqa: E402


def _mod(name):
    # both packages export functions named like their modules (rtrc,
    # rc_fctn, rnc_fctn, svt), which hide the modules from `from ... import`
    return importlib.import_module(name)


jbaselines, baselines = _mod("tritd_tpu.baselines"), _mod("tritd_tpu_torch.baselines")
jttnn, ttnn = _mod("tritd_tpu.baselines.ttnn"), _mod("tritd_tpu_torch.baselines.ttnn")
jrtrc, rtrc = _mod("tritd_tpu.baselines.rtrc"), _mod("tritd_tpu_torch.baselines.rtrc")
jfctn, rc_fctn = _mod("tritd_tpu.baselines.rc_fctn"), _mod("tritd_tpu_torch.baselines.rc_fctn")
jrnc, rnc_fctn = _mod("tritd_tpu.baselines.rnc_fctn"), _mod("tritd_tpu_torch.baselines.rnc_fctn")
jtrpca, trpca = _mod("tritd_tpu.baselines.trpca"), _mod("tritd_tpu_torch.baselines.trpca")
jsvt, tsvt = _mod("tritd_tpu.ops.svt"), _mod("tritd_tpu_torch.ops.svt")

RTOL = 1e-7
SUBDIM = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(shape=(12, 10, 16), seed=7, missing=0.10):
    """Mixed-structure traffic stand-in (O(100) range) with missing entries:
    (truth, observed mask, zero-filled data), float64 numpy."""
    spec = DatasetSpec("tiny", "traffic", "T", shape, fctn_subdim=SUBDIM, sofia_period=4)
    x = synthetic_traffic(spec, np.random.default_rng(seed)).astype(np.float64)
    mask = uniform_missing_mask(np.random.default_rng(seed + 1), shape, missing)
    return x, mask, np.where(mask, x, 0.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hist_close(got, want, n=None):
    got = np.asarray(got)[:n]
    want = np.asarray(want)[:n]
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _tensor_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * max(np.linalg.norm(want), 1.0))


def test_all_names_equal_jax():
    assert baselines.__all__ == jbaselines.__all__
    for name in baselines.__all__:
        assert callable(getattr(baselines, name))


@pytest.mark.parametrize("nway", [(100, 100, 500), (12, 10, 16), (54, 4, 1440), (100, 100, 50, 10), (3, 4, 5, 6, 7)])
def test_weight_tc_equals_jax(nway):
    assert ttnn.weight_tc(nway) == jttnn.weight_tc(nway)
    assert sum(ttnn.weight_tc(nway)) == pytest.approx(1.0)


@pytest.mark.parametrize("nway", [(100, 100, 50, 10), (240, 320, 20, 15), (12, 10, 4, 4), (3, 4, 5, 6, 7, 8), (5, 6)])
def test_bipartitions_and_weight_fctn_equal_jax(nway):
    orders = rc_fctn.balanced_bipartitions(len(nway))
    assert orders == jfctn.balanced_bipartitions(len(nway))
    assert rc_fctn.weight_fctn(nway, orders) == jfctn.weight_fctn(nway, orders)
    half = len(nway) // 2
    dims_l = [math.prod(nway[o] for o in order[:half]) for order in orders]
    assert rc_fctn._bipartition_shapes(nway, dims_l) == jfctn._bipartition_shapes(nway, dims_l)


def test_golden_cut_shapes_at_the_published_sizes():
    """The unfoldings the SVT sees at taxi (100x100x500) and video
    (240x320x300), as the reference's shapes give them."""
    taxi4, video4 = (100, 100, 50, 10), (240, 320, 20, 15)
    for nway, want in ((taxi4, [(10000, 500), (5000, 1000), (1000, 5000)]),
                       (video4, [(76800, 300), (4800, 4800), (3600, 6400)])):
        orders = rc_fctn.balanced_bipartitions(4)
        dims_l = [nway[o[0]] * nway[o[1]] for o in orders]
        assert rc_fctn._bipartition_shapes(nway, dims_l) == want
    assert tuple(rc_fctn._split_mode3(torch.zeros(100, 100, 500), 50, 10).shape) == taxi4
    assert tuple(rc_fctn._split_mode3(torch.zeros(240, 320, 300), 20, 15).shape) == video4
    assert rc_fctn.resolve_video_svt_method("auto") == jfctn.resolve_video_svt_method("auto") == "auto:512"
    for explicit in ("svd", "gram", "auto:256", "lowrank:512", "warm:8"):
        assert rc_fctn.resolve_video_svt_method(explicit) == explicit
    assert rc_fctn.VIDEO_SVT_BUDGET == jfctn.VIDEO_SVT_BUDGET


@pytest.mark.parametrize("n3, n4", [(4, 4), (2, 8), (8, 2), (16, 1)])
def test_split_mode3_is_the_column_major_reshape(n3, n4):
    x = np.random.default_rng(0).standard_normal((5, 3, 16))
    got = rc_fctn._split_mode3(_t(x), n3, n4)
    np.testing.assert_array_equal(got.numpy(), np.reshape(x, (5, 3, n3, n4), order="F"))
    with jax.enable_x64(True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfctn._split_mode3(jnp.asarray(x), n3, n4)))
    back = rc_fctn._merge_mode3(got)
    np.testing.assert_array_equal(back.numpy(), x)
    assert got.is_contiguous() and back.is_contiguous()


@pytest.mark.parametrize("svt_method", ["svd", "gram"])
def test_tt_trpca_matches_jax(svt_method):
    x, _mask, y = _problem()
    with jax.enable_x64(True):
        jz, js, jhist, jn = jttnn.tt_trpca(jnp.asarray(y), origin=jnp.asarray(x), max_iter=20,
                                           svt_method=svt_method)
        jz, js, jhist = np.asarray(jz), np.asarray(js), np.asarray(jhist)
    z, s, hist, n = ttnn.tt_trpca(_t(y), origin=_t(x), max_iter=20, svt_method=svt_method)
    assert n == jn == 20 and hist.dtype == torch.float64
    assert jhist[-1] < 0.99 * jhist[0]  # the problem moves
    _hist_close(hist, jhist)
    _tensor_close(z, jz)
    _tensor_close(s, js)


def test_tt_trpca_without_origin_leaves_nan_history():
    _x, _mask, y = _problem()
    z, _s, hist, n = ttnn.tt_trpca(_t(y), max_iter=3, svt_method="gram")
    assert n == 3 and torch.isnan(hist).all() and torch.isfinite(z).all()


@pytest.mark.parametrize("svt_method", ["svd", "gram", "auto"])
def test_rtrc_matches_jax(svt_method):
    x, mask, y = _problem()
    with jax.enable_x64(True):
        jx, jy, jhist, _ = jrtrc.rtrc(jnp.asarray(y), jnp.asarray(mask), origin=jnp.asarray(x), max_iter=20,
                                      svt_method=svt_method)
        jx, jy, jhist = np.asarray(jx), np.asarray(jy), np.asarray(jhist)
    xh, yh, hist, n = rtrc.rtrc(_t(y), _t(mask), origin=_t(x), max_iter=20, svt_method=svt_method)
    assert n == 20
    _hist_close(hist, jhist)
    _tensor_close(xh, jx)
    _tensor_close(yh, jy)


def test_rtrc_refuses_the_randomized_route():
    _x, mask, y = _problem()
    with pytest.raises(ValueError, match="only valid for tail-truncating"):
        rtrc.rtrc(_t(y), _t(mask), max_iter=1, svt_method="lowrank:4")


def test_freedom_ratio_matches_jax_and_caches_by_content():
    x, mask, y = _problem()
    with jax.enable_x64(True):
        jfr, jem = jrtrc.freedom_ratio(np.asarray(y), np.asarray(mask, np.float64), use_cache=False)
    fr, emm = rtrc.freedom_ratio(_t(y), _t(mask.astype(np.float64)), use_cache=False)
    assert fr == jfr
    np.testing.assert_array_equal(emm, jem)
    rtrc._FREEDOM_RATIO_CACHE.clear()
    first = rtrc.precompute_freedom_ratio(_t(x), _t(mask))
    assert len(rtrc._FREEDOM_RATIO_CACHE) == 1
    # rtrc fingerprints tnsr * mask (whose zeros carry the sign of tnsr)
    p = _t(mask.astype(np.float64))
    key = rtrc._fingerprint(_t(x) * p, p)
    assert rtrc._FREEDOM_RATIO_CACHE[key] is first
    assert rtrc.freedom_ratio(_t(x) * p, p) is first  # a hit, not a rerun
    rtrc.rtrc(_t(x), _t(mask), max_iter=1)
    assert len(rtrc._FREEDOM_RATIO_CACHE) == 1  # the solve found it too
    other = rtrc._fingerprint(_t(x) * p * 1.5, p)
    assert other != key and other[0] == key[0]
    # the fingerprint fetches a strided sample only
    big = torch.zeros(100, 100, 500)
    strides = tuple(max(1, s // 40) for s in big.shape)
    assert big[tuple(slice(None, None, st) for st in strides)].numel() * 40 < big.numel()


@pytest.mark.parametrize("svt_method", ["svd", "gram"])
@pytest.mark.parametrize("driver", ["traffic", "video"])
def test_rc_fctn_drivers_match_jax(driver, svt_method):
    x, mask, y = _problem()
    name = f"rc_fctn_driver_{driver}"
    with jax.enable_x64(True):
        jx, js, jhist = getattr(jfctn, name)(jnp.asarray(y), jnp.asarray(mask), SUBDIM, origin=jnp.asarray(x),
                                             max_iter=15, svt_method=svt_method)
        jx, js, jhist = np.asarray(jx), np.asarray(js), np.asarray(jhist)
    xh, s, hist = getattr(rc_fctn, name)(_t(y), _t(mask), SUBDIM, origin=_t(x), max_iter=15,
                                         svt_method=svt_method)
    assert xh.shape == s.shape == x.shape
    _hist_close(hist, jhist)
    _tensor_close(xh, jx)
    _tensor_close(s, js)


def test_rc_fctn_video_default_route_is_auto():
    """The video driver's default resolves to auto:512, which at a small
    shape is the gram route."""
    x, mask, y = _problem()
    default = rc_fctn.rc_fctn_driver_video(_t(y), _t(mask), SUBDIM, origin=_t(x), max_iter=5)
    gram = rc_fctn.rc_fctn_driver_video(_t(y), _t(mask), SUBDIM, origin=_t(x), max_iter=5, svt_method="gram")
    for a, b in zip(default, gram):
        assert torch.equal(a, b)


def test_rc_fctn_chunked_equals_one_block_and_jax():
    x, mask, y = _problem()
    y4, x4 = rc_fctn._split_mode3(_t(y), 4, 4), rc_fctn._split_mode3(_t(x), 4, 4)
    ind = rc_fctn._split_mode3(_t(mask.astype(np.float64)), 4, 4)
    whole = rc_fctn.rc_fctn(y4, 1.8, ind, origin=x4, f=0.7, max_iter=12, svt_method="gram")
    for chunk in (5, 12, 100):
        parts = rc_fctn.rc_fctn(y4, 1.8, ind, origin=x4, f=0.7, max_iter=12, svt_method="gram", chunk=chunk)
        for a, b in zip(whole, parts):
            assert torch.equal(a, b)
    with jax.enable_x64(True):
        _, _, jhist = jfctn.rc_fctn(jnp.asarray(y4.numpy()), 1.8, jnp.asarray(ind.numpy()),
                                    origin=jnp.asarray(x4.numpy()), f=0.7, max_iter=12, svt_method="gram", chunk=5)
        jhist = np.asarray(jhist)
    _hist_close(whole[2], jhist)


@pytest.mark.parametrize("method", ["ttnn", "ring", "fctn"])
def test_warm_route_matches_jax(method, monkeypatch):
    """`warm:4` with the warm threshold lowered to 8 on both sides, so the
    unfoldings of this small problem carry a basis; the rc_fctn run is
    chunked by its driver (25), here 18 iterations in one block, and again
    through `rc_fctn` in chunks of 7 (refreshes at 0, 4 of each chunk)."""
    monkeypatch.setattr(jsvt, "WARM_MIN_DIM", 8)
    monkeypatch.setattr(tsvt, "WARM_MIN_DIM", 8)
    # a shape no other test traces, so no stale compiled JAX program is hit
    x, mask, y = _problem(shape=(12, 10, 20), seed=11)
    n = 18
    with jax.enable_x64(True):
        jargs = dict(origin=jnp.asarray(x), max_iter=n, svt_method="warm:4")
        if method == "ttnn":
            jhist = jttnn.tt_trpca(jnp.asarray(y), **jargs)[2]
        elif method == "ring":
            jhist = jrtrc.rtrc(jnp.asarray(y), jnp.asarray(mask), **jargs)[2]
        else:
            jhist = jfctn.rc_fctn_driver_traffic(jnp.asarray(y), jnp.asarray(mask), SUBDIM, **jargs)[2]
        jhist = np.asarray(jhist)
    targs = dict(origin=_t(x), max_iter=n, svt_method="warm:4")
    if method == "ttnn":
        hist = ttnn.tt_trpca(_t(y), **targs)[2]
        exact = ttnn.tt_trpca(_t(y), **{**targs, "svt_method": "gram"})[2]
    elif method == "ring":
        hist = rtrc.rtrc(_t(y), _t(mask), **targs)[2]
        exact = rtrc.rtrc(_t(y), _t(mask), **{**targs, "svt_method": "gram"})[2]
    else:
        hist = rc_fctn.rc_fctn_driver_traffic(_t(y), _t(mask), SUBDIM, **targs)[2]
        exact = rc_fctn.rc_fctn_driver_traffic(_t(y), _t(mask), SUBDIM, **{**targs, "svt_method": "gram"})[2]
    _hist_close(hist, jhist)
    # a stale basis was really used: the run is near the exact one, not on it
    gap = np.abs(hist.numpy() - exact.numpy()).max()
    assert 0.0 < gap < 0.2

    if method == "fctn":
        y4, x4 = rc_fctn._split_mode3(_t(y), 5, 4), rc_fctn._split_mode3(_t(x), 5, 4)
        ones = torch.ones_like(y4)
        lam = 5000.0 / math.sqrt(12 * 20)
        chunked = rc_fctn.rc_fctn(y4, lam, ones, origin=x4, max_iter=n, svt_method="warm:4", chunk=7)[2]
        with jax.enable_x64(True):
            jchunked = np.asarray(jfctn.rc_fctn(jnp.asarray(y4.numpy()), lam, jnp.asarray(ones.numpy()),
                                                origin=jnp.asarray(x4.numpy()), max_iter=n,
                                                svt_method="warm:4", chunk=7)[2])
        _hist_close(chunked, jchunked)
        assert np.abs(chunked.numpy() - hist.numpy()).max() > 0.0  # another schedule, another result


def test_prox_tnn_matches_jax():
    rng = np.random.default_rng(3)
    y = rng.standard_normal((7, 6, 9)) * 4
    with jax.enable_x64(True):
        want = np.asarray(jtrpca.prox_tnn(jnp.asarray(y), 1.5))
    got = trpca.prox_tnn(_t(y), 1.5)
    assert got.dtype == torch.float64 and got.shape == y.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    got32 = trpca.prox_tnn(_t(y).float(), 1.5)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want, atol=1e-4)


def test_trpca_tnn_matches_jax():
    x, _mask, y = _problem()
    with jax.enable_x64(True):
        jl, js, jhist = jtrpca.trpca_tnn(jnp.asarray(y), origin=jnp.asarray(x), mu=1e-3, max_iter=20)
        jl, js, jhist = np.asarray(jl), np.asarray(js), np.asarray(jhist)
    l, s, hist = trpca.trpca_tnn(_t(y), origin=_t(x), mu=1e-3, max_iter=20)
    _hist_close(hist, jhist)
    _tensor_close(l, jl)
    _tensor_close(s, js)
    # the default lambda and a capped penalty
    with jax.enable_x64(True):
        jhist = np.asarray(jtrpca.trpca_tnn(jnp.asarray(y), origin=jnp.asarray(x), mu=1e-3, rho=1.5,
                                            max_mu=5e-3, max_iter=8)[2])
    _hist_close(trpca.trpca_tnn(_t(y), origin=_t(x), mu=1e-3, rho=1.5, max_mu=5e-3, max_iter=8)[2], jhist)


def test_trpca_snn_matches_jax():
    _x, _mask, y = _problem()
    with jax.enable_x64(True):
        jl, je, jhist = jtrpca.trpca_snn(jnp.asarray(y), alpha=(1.0, 0.8, 1.2), mu=1e-3, max_iter=20)
        jl, je, jhist = np.asarray(jl), np.asarray(je), np.asarray(jhist)
    l, e, hist = trpca.trpca_snn(_t(y), alpha=(1.0, 0.8, 1.2), mu=1e-3, max_iter=20)
    _hist_close(hist, jhist)
    _tensor_close(l, jl)
    _tensor_close(e, je)
    assert torch.isfinite(trpca.trpca_snn(_t(y), max_iter=2)[2]).all()


def _rnc_problem(seed=5):
    rng = np.random.default_rng(seed)
    nway = (7, 6, 5, 4)
    rank = np.triu(np.full((4, 4), 2), 1)
    gs = [rng.random(tuple(int(v) for v in d)) for d in np.diag(nway) + rank + rank.T]
    truth = np.einsum("aqrs,qbtu,rtcv,suvd->abcd", *gs)
    truth = truth / np.abs(truth).max()
    omega = rng.random(nway) > 0.2
    spikes = np.where(rng.random(nway) < 0.05, 0.8, 0.0)
    return truth, omega, np.where(omega, truth + spikes, 0.0)


def test_fctn_compose_and_chain_einsum():
    rng = np.random.default_rng(0)
    rank = np.array([[0, 2, 3, 2], [0, 0, 2, 4], [0, 0, 0, 3], [0, 0, 0, 0]])
    gs = [rng.standard_normal(tuple(int(v) for v in d)) for d in np.diag((5, 4, 6, 3)) + rank + rank.T]
    want = np.einsum(rnc_fctn._SPEC, *gs)
    np.testing.assert_allclose(rnc_fctn.fctn_compose([_t(g) for g in gs]).numpy(), want, rtol=1e-12, atol=1e-12)
    with jax.enable_x64(True):
        np.testing.assert_allclose(want, np.asarray(jrnc.fctn_compose([jnp.asarray(g) for g in gs])), rtol=1e-12,
                                   atol=1e-12)
    assert rnc_fctn._SPEC == jrnc._SPEC and rnc_fctn._REST_SPECS == jrnc._REST_SPECS
    for i, spec in rnc_fctn._REST_SPECS.items():
        others = [g for j, g in enumerate(gs) if j != i]
        got = rnc_fctn._chain_einsum(spec, *[_t(g) for g in others]).numpy()
        np.testing.assert_allclose(got, np.einsum(spec, *others), rtol=1e-12, atol=1e-12)


def test_rnc_fctn_matches_jax_from_its_draws():
    """The JAX solver draws its factors and one padding scalar per rank
    growth from its key; the same numbers are handed to the port."""
    truth, omega, f = _rnc_problem()
    rank = np.triu(np.full((4, 4), 2), 1)
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(3)
        init, _ = jrnc._init_factors(key, f.shape, rank, jnp.float64)
        init = [np.array(g) for g in init]
        pads, k = [], key
        for _ in range(8):
            k, sub = jax.random.split(k)
            pads.append(float(jax.random.uniform(sub, ())))
        jx, jgs, je, jhist, jn = jrnc.rnc_fctn(jnp.asarray(f), 0.3, jnp.asarray(omega), origin=jnp.asarray(truth),
                                               max_iter=30, key=key)
        jx, je, jgs = np.asarray(jx), np.asarray(je), [np.asarray(g) for g in jgs]
    used = []

    def pad_values():
        for p in pads:
            used.append(p)
            yield p

    x, gs, e, hist, n = rnc_fctn.rnc_fctn(_t(f), 0.3, _t(omega), origin=_t(truth), max_iter=30, init=init,
                                          pad_values=pad_values())
    assert n == jn and len(used) >= 1  # the rank grew at least once
    assert [tuple(g.shape) for g in gs] == [g.shape for g in jgs]
    assert gs[0].shape[1] == 3  # 2 -> 3, the default max_rank
    _hist_close(hist, jhist)
    _tensor_close(x, jx)
    _tensor_close(e, je)
    for g, jg in zip(gs, jgs):
        _tensor_close(g, jg)


def test_rnc_fctn_own_draws_repeat_and_refuse_other_orders():
    truth, omega, f = _rnc_problem()
    a = rnc_fctn.rnc_fctn(_t(f), 0.3, _t(omega), origin=_t(truth), max_iter=12,
                          generator=torch.Generator().manual_seed(4))
    b = rnc_fctn.rnc_fctn(_t(f), 0.3, _t(omega), origin=_t(truth), max_iter=12,
                          generator=torch.Generator().manual_seed(4))
    assert torch.equal(a[0], b[0]) and np.array_equal(a[3], b[3]) and a[3][-1] < a[3][0]
    gs = rnc_fctn._init_factors(torch.Generator().manual_seed(0), f.shape, np.triu(np.full((4, 4), 2), 1),
                                torch.float64)
    assert [tuple(g.shape) for g in gs] == [(7, 2, 2, 2), (2, 6, 2, 2), (2, 2, 5, 2), (2, 2, 2, 4)]
    assert all(0.0 <= float(g.min()) and float(g.max()) < 1.0 for g in gs)
    with pytest.raises(ValueError, match="4-way"):
        rnc_fctn.rnc_fctn(torch.zeros(3, 4, 5), 0.1, torch.ones(3, 4, 5, dtype=torch.bool))


def test_interpolate_init_matches_jax():
    rng = np.random.default_rng(1)
    i, j, t = np.meshgrid(np.arange(10), np.arange(9), np.arange(4), indexing="ij")
    truth = ((0.3 + 0.02 * i + 0.03 * j + 0.05 * t) / 2.0).reshape(10, 9, 2, 2)
    omega = rng.random(truth.shape) > 0.3
    f = np.where(omega, truth, 0.0)
    with jax.enable_x64(True):
        want = np.asarray(jrnc.interpolate_init(jnp.asarray(f), jnp.asarray(omega), pad=3))
    got = rnc_fctn.interpolate_init(_t(f), _t(omega), pad=3)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.numpy()[omega], truth[omega])
    full = rnc_fctn.interpolate_init(_t(truth).float(), torch.ones(truth.shape, dtype=torch.bool), pad=3)
    assert full.dtype == torch.float32
    np.testing.assert_allclose(full.numpy(), truth, atol=1e-6)


# --- the numpy MATLAB emulator ------------------------------------------------

EM_ITERS = 30


def _em_problem():
    return _problem(shape=(9, 7, 24), seed=7)


def test_tt_trpca_matches_the_emulator():
    x, _mask, y = _em_problem()
    want = em.tt_trpca_em(y, x, max_iter=EM_ITERS)
    z, s, hist, _ = ttnn.tt_trpca(_t(y), origin=_t(x), max_iter=EM_ITERS, svt_method="svd")
    np.testing.assert_allclose(hist.numpy(), want["err_hist"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(z.numpy(), want["z"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(s.numpy(), want["s"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("mu", [1e-1, 1e-3], ids=["traffic", "video"])
def test_rtrc_matches_the_emulator(mu):
    x, mask, y = _em_problem()
    want = em.rtrc_em(y, mask.astype(np.float64), x, mu=mu, max_iter=EM_ITERS)
    xh, yh, hist, _ = rtrc.rtrc(_t(y), _t(mask), mu=mu, origin=_t(x), max_iter=EM_ITERS, svt_method="svd")
    np.testing.assert_allclose(hist.numpy(), want["err_hist"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(xh.numpy(), want["x"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(yh.numpy(), want["y"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("driver", ["traffic", "video"])
def test_rc_fctn_matches_the_emulator(driver):
    x, mask, y = _em_problem()
    i, j, k = y.shape
    if driver == "video":
        shape4, lam, f = (i, j, SUBDIM, k // SUBDIM), 1.8, 0.7
        ind1 = np.reshape(mask.astype(np.float64), shape4, order="F")
    else:
        shape4, lam, f = (i, j, k // SUBDIM, SUBDIM), 5000.0 / math.sqrt(max(i, j) * k), 0.1
        ind1 = np.ones(shape4)  # the traffic driver marks everything observed
    want = em.rc_fctn_em(np.reshape(y, shape4, order="F"), lam, ind1, np.reshape(x, shape4, order="F"),
                         f=f, gamma=1e-3, deta=1e-3, maxit=EM_ITERS)
    run = getattr(rc_fctn, f"rc_fctn_driver_{driver}")
    xh, s, hist = run(_t(y), _t(mask), SUBDIM, origin=_t(x), max_iter=EM_ITERS, svt_method="svd")
    np.testing.assert_allclose(hist.numpy(), want["rse_real"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(xh.numpy(), np.reshape(want["x"], x.shape, order="F"), rtol=0, atol=1e-8)
    np.testing.assert_allclose(s.numpy(), np.reshape(want["s"], x.shape, order="F"), rtol=0, atol=1e-8)


@pytest.mark.parametrize("fn, args", [
    ("tt_trpca", ()), ("rtrc", ("mask",)), ("rc_fctn_driver_traffic", ("mask", SUBDIM)),
    ("rc_fctn_driver_video", ("mask", SUBDIM)),
])
def test_float32_runs_stay_float32_and_near_float64(fn, args):
    """The run's dtype is the input's; penalties grow in that dtype. The
    float32 trajectory stays within 1e-3 of the float64 one over 10
    iterations (rounding carried through the discontinuous gate)."""
    x, mask, y = _problem()
    module = {"tt_trpca": ttnn, "rtrc": rtrc}.get(fn, rc_fctn)
    outs = {}
    for dtype in (torch.float32, torch.float64):
        a = [_t(mask) if v == "mask" else v for v in args]
        out = getattr(module, fn)(_t(y).to(dtype), *a, origin=_t(x).to(dtype), max_iter=10, svt_method="gram")
        assert out[0].dtype == out[1].dtype == out[2].dtype == dtype
        outs[dtype] = out[2].double().numpy()
    np.testing.assert_allclose(outs[torch.float32], outs[torch.float64], rtol=1e-3)
