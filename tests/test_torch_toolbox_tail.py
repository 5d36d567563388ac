"""PyTorch port, Tensor Toolbox classes II: the long-tail class methods, twin
for twin with `tests/test_toolbox_tail.py`.

Each twin keeps the reference test's dense-oracle assertion, made on the
port, and holds the port to the JAX classes on the same numpy float64
inputs (JAX under `jax.enable_x64`) to rtol 1e-12 (`RTOL`); eigenvectors
up to sign. The reference's jit test of the new sparse methods becomes a
device/dtype test, its autodiff check of `SymKTensor.fg` runs on
`torch.autograd` against `jax.grad`, and the audit test runs the port's
own audit (`tritd_tpu_torch.tools.toolbox_audit`), which needs no toolbox
sources and so never skips. The three open faults of the reference's
classes each have a test at the end showing where port and reference agree
and where they part."""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_toolbox_helpers import close, n, one_torch_thread, x64  # noqa: E402
from tritd_tpu.ops import classes as JC  # noqa: E402
from tritd_tpu.ops import symmetric as jsym  # noqa: E402
from tritd_tpu_torch.ops import classes as C  # noqa: E402
from tritd_tpu_torch.ops import tenutils as tu  # noqa: E402
from tritd_tpu_torch.tools import toolbox_audit  # noqa: E402

RTOL = 1e-12
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def T(a, dtype=torch.float64):
    out = torch.from_numpy(np.array(a))
    return out.to(dtype) if out.is_floating_point() else out


def _rng(seed):
    return np.random.default_rng(seed)


def _sp_arrays(shape, nnz, seed):
    g = _rng(seed)
    coords = np.stack([g.integers(0, s, size=nnz) for s in shape], axis=1)
    return g.standard_normal(nnz), coords


def _pair_sp(shape, nnz, seed):
    """The same sparse tensor in both packages (JAX built inside x64)."""
    vals, coords = _sp_arrays(shape, nnz, seed)
    return C.SpTensor(T(vals), T(coords), shape), (vals, coords.astype(np.int32), shape)


def _jsp(arrays):
    vals, coords, shape = arrays
    return JC.SpTensor(jnp.asarray(vals), jnp.asarray(coords), shape)


@pytest.fixture(scope="module")
def sp():
    return _pair_sp((4, 3, 5), 9, 1)


@pytest.fixture(scope="module")
def kt():
    g = _rng(2)
    us, w = [g.standard_normal((s, 3)) for s in (4, 3, 5)], g.standard_normal(3)
    return C.KTensor([T(u) for u in us], T(w)), (us, w)


@pytest.fixture(scope="module")
def tt():
    g = _rng(3)
    core = g.standard_normal((2, 3, 2))
    us = [g.standard_normal((s, r)) for s, r in ((4, 2), (3, 3), (5, 2))]
    return C.TTensor(T(core), [T(u) for u in us]), (core, us)


def _jkt(arrays):
    us, w = arrays
    return JC.KTensor([jnp.asarray(u) for u in us], jnp.asarray(w))


# ---------------------------------------------------------------- @tensor


def test_tensor_mttkrps_matches_per_mode():
    g = _rng(4)
    x = g.standard_normal((4, 3, 5))
    us = [g.standard_normal((s, 2)) for s in (4, 3, 5)]
    seq = C.Tensor(T(x)).mttkrps([T(u) for u in us])
    with x64():
        jseq = JC.Tensor(jnp.asarray(x)).mttkrps([jnp.asarray(u) for u in us])
    for m, (got, want) in enumerate(zip(seq, jseq)):
        close(got, C.Tensor(T(x)).mttkrp([T(u) for u in us], m), RTOL)
        close(got, want, RTOL)


def test_tensor_with_set_subsasgn():
    x = C.Tensor(torch.zeros((3, 3), dtype=torch.float64))
    y = x.with_set((1, 2), 5.0)
    assert float(y.data[1, 2]) == 5.0
    assert float(x.data[1, 2]) == 0.0  # immutable
    with x64():
        jy = JC.Tensor(jnp.zeros((3, 3))).with_set((1, 2), 5.0)
    np.testing.assert_array_equal(n(y.data), np.asarray(jy.data))


# -------------------------------------------------------------- @sptensor


def test_sptensor_comparisons_and_logicals(sp):
    s, arrays = sp
    d = n(s.double())
    other, oarrays = _pair_sp(s.shape, 5, 5)
    od = n(other.double())
    np.testing.assert_array_equal(n((s == 0).data), d == 0)
    np.testing.assert_array_equal(n((s != 0).data), d != 0)
    np.testing.assert_array_equal(n((s > 0).data), d > 0)
    np.testing.assert_array_equal(n((s <= 0).data), d <= 0)
    np.testing.assert_array_equal(n(s.logical_and(other).data), (d != 0) & (od != 0))
    np.testing.assert_array_equal(n(s.logical_xor(other).data), (d != 0) ^ (od != 0))
    np.testing.assert_array_equal(n(s.logical_not().data), d == 0)
    with x64():
        js, jo = _jsp(arrays), _jsp(oarrays)
        for op in ("__lt__", "__ge__", "logical_or"):
            np.testing.assert_array_equal(n(getattr(s, op)(other).data), np.asarray(getattr(js, op)(jo).data))
    assert bool(s.isequal(C.SpTensor(s.vals, s.coords, s.shape)))
    assert not bool(s.isequal(other)) and not s.isscalar()


def test_sptensor_getitem_and_with_set(sp):
    s, arrays = sp
    d = n(s.double())
    i, j, k = (int(c) for c in n(s.coords)[0])
    assert np.isclose(float(s[i, j, k]), d[i, j, k])
    assert np.isclose(float(s[torch.tensor(i), j, -5 + k]), d[i, j, k])  # 0-d tensors, negative subscripts
    np.testing.assert_array_equal(n(s[-1].data), d[-1])
    y = s.with_set([[i, j, k]], [99.0])
    assert np.isclose(float(y[i, j, k]), 99.0)  # replaced, not accumulated
    np.testing.assert_array_equal(n(y.double())[0, 0, 0], d[0, 0, 0])
    with x64():
        jy = _jsp(arrays).with_set([[i, j, k]], [99.0])
        close(y.double(), jy.double(), RTOL)
    assert y.nnz == jy.nnz


def test_sptensor_collapse_contract_scale(sp):
    s, arrays = sp
    d = n(s.double())
    cub, carrays = _pair_sp((4, 4, 3), 8, 6)
    sc = _rng(7).standard_normal(3)
    close(s.collapse((1,)).data, d.sum(axis=1), RTOL)
    assert np.isclose(float(s.collapse()), d.sum(), rtol=RTOL)
    np.testing.assert_array_equal(n(s.collapse((0,), fun=torch.amax).data), d.max(axis=0))
    close(cub.contract(0, 1).data, np.einsum("iik->k", n(cub.double())), RTOL)
    close(s.scale(T(sc), 1).double(), d * sc[None, :, None], RTOL)
    with x64():
        js, jc = _jsp(arrays), _jsp(carrays)
        want = [js.collapse((1,)).data, js.collapse(), jc.contract(0, 1).data, js.scale(jnp.asarray(sc), 1).double()]
    for got, w in zip([s.collapse((1,)).data, s.collapse(), cub.contract(0, 1).data, s.scale(T(sc), 1).double()], want):
        close(got, w, RTOL)


def test_sptensor_divide_by_ktensor(sp, kt):
    s, arrays = sp
    _, (us, w) = kt
    pos_us, pos_w = [np.abs(u) for u in us], np.abs(w)
    kpos = C.KTensor([T(u) for u in pos_us], T(pos_w))
    out = s.divide(kpos)
    coords = n(s.coords)
    expect = n(s.vals) / np.maximum(n(kpos.double())[tuple(coords.T)], 1e-10)
    close(out.vals, expect, RTOL)
    with x64():
        jout = _jsp(arrays).divide(_jkt((pos_us, pos_w)))
    close(out.vals, jout.vals, RTOL)


def test_sptensor_mask_nvecs_ones_spmatrix(sp):
    s, arrays = sp
    d = n(s.double())
    w, warrays = _pair_sp(s.shape, 4, 8)
    close(s.mask(w), d[tuple(n(w.coords).T)], RTOL)
    v_sp = n(s.nvecs(0, 2))
    close(np.abs(v_sp), np.abs(n(tu.nvecs(s.double(), 0, 2))), 1e-10)
    assert np.all(n(s.ones().vals) == 1)
    two, tarrays = _pair_sp((4, 6), 5, 9)
    np.testing.assert_array_equal(n(two.spmatrix()), n(two.double()))
    with x64():
        js = _jsp(arrays)
        jmask, jv = js.mask(_jsp(warrays)), js.nvecs(0, 2)
        jmat = _jsp(tarrays).spmatrix()
    close(s.mask(w), jmask, RTOL)
    close(v_sp, jv, 1e-10)  # both fix the sign of the largest entry
    close(two.spmatrix(), jmat, RTOL)


def test_sptensor_reshape_squeeze(sp):
    s, arrays = sp
    d = n(s.double())
    r = s.reshape((2, 2, 15))
    np.testing.assert_array_equal(n(r.double()), d.reshape(2, 2, 15))
    s3 = C.SpTensor(s.vals, s.coords * torch.tensor([1, 0, 1]), (4, 1, 5))
    sq = s3.squeeze()
    assert sq.shape == (4, 5)
    with x64():
        jr = _jsp(arrays).reshape((2, 2, 15))
        jsq = JC.SpTensor(jnp.asarray(arrays[0]), jnp.asarray(arrays[1] * [1, 0, 1]), (4, 1, 5)).squeeze()
        close(sq.double(), jsq.double(), RTOL)
    np.testing.assert_array_equal(n(r.coords), np.asarray(jr.coords))


def test_sptensor_ttm_matches_dense(sp):
    s, arrays = sp
    d = s.double()
    g = _rng(10)
    u0, u1 = g.standard_normal((6, 4)), g.standard_normal((2, 3))
    close(s.ttm(T(u0), 0).data, tu.ttm(d, T(u0), 0), RTOL)
    got = s.ttm([T(u0), T(u1)], [0, 1]).data
    close(got, tu.ttm(tu.ttm(d, T(u0), 0), T(u1), 1), RTOL)
    close(s.ttm(T(u0.T), 0, transpose=True).data, tu.ttm(d, T(u0), 0), RTOL)
    with x64():
        js = _jsp(arrays)
        want = [js.ttm(jnp.asarray(u0), 0).data, js.ttm([jnp.asarray(u0), jnp.asarray(u1)], [0, 1]).data]
    close(s.ttm(u0, 0).data, want[0], RTOL)
    close(got, want[1], RTOL)


def test_sptensor_ttt_outer_and_contracted():
    a, aarr = _pair_sp((2, 3), 4, 11)
    b, barr = _pair_sp((4, 2), 3, 12)
    outer = a.ttt(b)
    assert isinstance(outer, C.SpTensor)
    close(outer.double(), np.multiply.outer(n(a.double()), n(b.double())), RTOL)
    inner = a.ttt(b, adims=[0], bdims=[1])
    close(inner.data, np.einsum("ij,ki->jk", n(a.double()), n(b.double())), RTOL)
    with x64():
        ja, jb = _jsp(aarr), _jsp(barr)
        jouter, jinner = ja.ttt(jb), ja.ttt(jb, adims=[0], bdims=[1])
    np.testing.assert_array_equal(n(outer.coords), np.asarray(jouter.coords))
    close(outer.vals, jouter.vals, RTOL)
    close(inner.data, jinner.data, RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sptensor_new_methods_keep_device_and_dtype(sp, kt, dtype):
    """Twin of the reference's jit test of collapse/contract/scale/ttm/
    divide: each result lies on the tensor's device in its dtype, and the
    reference test's finite sum holds."""
    s64, _ = sp
    s = C.SpTensor(s64.vals.to(dtype), s64.coords, s64.shape)
    u = _rng(13).standard_normal((6, 4))
    out = s.ttm(u, 0).data.sum() + s.collapse((0,)).data.sum()
    assert np.isfinite(float(out)) and out.dtype == dtype
    k = C.KTensor([f.abs().to(dtype) for f in kt[0].factors], kt[0].weights.abs().to(dtype))
    results = [s.ttm(u, 0).data, s.collapse((0,)).data, s.collapse((0, 1)).data,
               s.scale(np.ones(3), 1).vals, s.divide(k).vals, s.mttkrp([np.ones((m, 2)) for m in s.shape], 1),
               s.ttv(np.ones(3), 1).data, s.norm(), s.coalesce().vals, s.to_sptenmat((0,)).double()]
    for r in results:
        assert r.device.type == "cpu" and r.dtype == dtype, (r.device, r.dtype)
    assert s.coalesce().coords.dtype == torch.int64


# --------------------------------------------------------------- @ktensor


def test_ktensor_extract_tocell_update(kt):
    k, arrays = kt
    ex = k.extract([0, 2])
    assert ex.ncomponents() == 2
    np.testing.assert_array_equal(n(ex.weights), n(k.weights)[[0, 2]])
    assert len(k.tocell()) == 3
    again = k.update([-1, 0, 1, 2], k.tovec())
    np.testing.assert_array_equal(n(again.double()), n(k.double()))
    with x64():
        jk = _jkt(arrays)
        close(ex.double(), jk.extract([0, 2]).double(), RTOL)
        close(again.double(), jk.update([-1, 0, 1, 2], jk.tovec()).double(), RTOL)


def test_ktensor_mask_entries(kt):
    k, arrays = kt
    w, warrays = _pair_sp(k.shape, 6, 14)
    got = k.mask(w)
    close(got, n(k.double())[tuple(n(w.coords).T)], RTOL)
    with x64():
        close(got, _jkt(arrays).mask(_jsp(warrays)), RTOL)


def test_ktensor_nvecs_matches_dense(kt):
    k, arrays = kt
    v_small = n(k.nvecs(1, 2))
    close(np.abs(v_small), np.abs(n(tu.nvecs(k.double(), 1, 2))), 1e-10)
    with x64():
        close(v_small, _jkt(arrays).nvecs(1, 2), 1e-10)


def test_ktensor_times_and_predicates(kt):
    k, arrays = kt
    d = n(k.double())
    sp4, sarrays = _pair_sp(k.shape, 5, 15)
    prod = k.times(sp4)
    assert isinstance(prod, C.SpTensor)
    close(prod.double(), d * n(sp4.double()), RTOL)
    close(k.times(C.Tensor(T(d))).data, d * d, RTOL)
    assert bool(k.isequal(C.KTensor([n(u) for u in k.factors], k.weights)))
    assert not k.isscalar()
    with x64():
        close(prod.vals, _jkt(arrays).times(_jsp(sarrays)).vals, RTOL)


def test_ktensor_ttm_symmetrize():
    g = _rng(16)
    u = [g.standard_normal((4, 2)) for _ in range(3)]
    v = g.standard_normal((6, 4))
    kt3 = C.KTensor([T(a) for a in u], T(np.array([1.5, -0.5])))
    got = kt3.ttm(T(v), 1)
    close(got.double(), tu.ttm(kt3.double(), T(v), 1), RTOL)
    sym = kt3.symmetrize()
    assert bool(sym.issymmetric())
    ktsym = C.KTensor([T(u[0])] * 3, T(np.array([1.0, 2.0])))
    close(ktsym.symmetrize().double(), ktsym.double(), 1e-10)
    u4 = g.standard_normal((3, 2))
    kt4 = C.KTensor([T(u4)] * 4, T(np.array([1.0, -2.0])))
    close(kt4.symmetrize().double(), kt4.double(), 1e-10)  # the even-order sign stays in λ
    with x64():
        jk3 = JC.KTensor([jnp.asarray(a) for a in u], jnp.asarray([1.5, -0.5]))
        jk4 = JC.KTensor([jnp.asarray(u4)] * 4, jnp.asarray([1.0, -2.0]))
        want = [jk3.ttm(jnp.asarray(v), 1).double(), jk3.symmetrize().double(), jk4.symmetrize().double()]
    for g_, w in zip([got.double(), sym.double(), kt4.symmetrize().double()], want):
        close(g_, w, RTOL)


# --------------------------------------------------------------- @ttensor


def test_ttensor_scalar_ops_permute_entry(tt):
    t_, (core, us) = tt
    d = n(t_.double())
    close((-t_).double(), -d, RTOL)
    close((t_ * 2.0).double(), 2 * d, RTOL)
    p = t_.permute((2, 0, 1))
    close(p.double(), np.transpose(d, (2, 0, 1)), RTOL)
    assert np.isclose(float(t_[1, 2, 3]), d[1, 2, 3], rtol=1e-12)
    assert bool(t_.isequal(C.TTensor(t_.core, [n(u) for u in t_.factors])))
    assert not t_.isscalar()
    with x64():
        jt = JC.TTensor(jnp.asarray(core), [jnp.asarray(u) for u in us])
        close(t_[1, 2, 3], jt[1, 2, 3], RTOL)
        close(p.double(), jt.permute((2, 0, 1)).double(), RTOL)


def test_ttensor_nvecs_matches_dense(tt):
    t_, (core, us) = tt
    v_small = n(t_.nvecs(0, 2))
    close(np.abs(v_small), np.abs(n(tu.nvecs(t_.double(), 0, 2))), 1e-10)
    with x64():
        close(v_small, JC.TTensor(jnp.asarray(core), [jnp.asarray(u) for u in us]).nvecs(0, 2), 1e-10)


# ------------------------------------------------- @tenmat / @sptenmat


def test_tenmat_indexing_and_with_set():
    x = _rng(17).standard_normal((3, 4, 2))
    tm = C.TenMat.from_tensor(T(x), (0,))
    assert float(tm[1, 5]) == float(tm.data[1, 5])
    y = tm.with_set((0, 0), 7.0)
    assert float(y.data[0, 0]) == 7.0 and float(tm.data[0, 0]) == x[0, 0, 0]
    assert float(y.to_tensor().data.reshape(-1)[0]) == 7.0
    with x64():
        jy = JC.TenMat.from_tensor(jnp.asarray(x), (0,)).with_set((0, 0), 7.0)
    np.testing.assert_array_equal(n(y.to_tensor().data), np.asarray(jy.to_tensor().data))


def test_sptenmat_aatx_full_norm(sp):
    s, arrays = sp
    am = s.to_sptenmat((0,))
    a = n(am.double())
    x = _rng(18).standard_normal(a.shape[0])
    close(am.aatx(T(x)), a @ (a.T @ x), RTOL)
    assert np.isclose(float(am.norm()), np.linalg.norm(a), rtol=RTOL)
    ftm = am.full()
    assert isinstance(ftm, C.TenMat)
    np.testing.assert_array_equal(n(ftm.data), a)
    assert am.tsize() == s.shape
    np.testing.assert_array_equal(n((-am).double()), -a)
    with x64():
        jam = _jsp(arrays).to_sptenmat((0,))
        close(am.aatx(x), jam.aatx(jnp.asarray(x)), RTOL)
        close(am.norm(), jam.norm(), RTOL)


# ------------------------------------------- @symtensor / @symktensor


def test_symtensor_indices_vals_and_elementwise():
    raw = _rng(19).standard_normal((3, 3, 3))
    x = C.SymTensor(T(raw))
    subs = x.indices()
    assert subs.shape == (10, 3)  # C(n+m-1, m) distinct monomials for n=3, m=3
    assert np.all(np.diff(subs, axis=1) >= 0)
    d = n(x.data)
    np.testing.assert_array_equal(n(x.vals()), d[tuple(subs.T)])
    close((x + x).data, 2 * d, RTOL)
    close((x * 3.0).data, 3 * d, RTOL)
    np.testing.assert_array_equal(n((-x).data), -d)
    np.testing.assert_array_equal(n((x > 0).data), d > 0)
    np.testing.assert_array_equal(n(x.logical_not().data), d == 0)
    assert bool(x.isequal(C.SymTensor(T(d), presymmetrized=True)))
    got = x.tenfun(lambda a, b: a + 2 * b, x)
    close(got.data, 3 * d, RTOL)
    assert np.isclose(float(x[0, 1, 2]), d[0, 1, 2])
    with x64():
        jx = JC.SymTensor(jnp.asarray(raw))
        np.testing.assert_array_equal(subs, jx.indices())
        want = [jx.data, jx.vals(), (jx + jx).data, (2.0 - jx).data, (jx / 2.0).data]
    for g_, w in zip([x.data, x.vals(), (x + x).data, (2.0 - x).data, (x / 2.0).data], want):
        close(g_, w, RTOL)


def test_symktensor_normalize_arrange_entry_score():
    g = _rng(20)
    u = g.standard_normal((4, 3))
    lam = np.array([2.0, -1.0, 0.5])
    k = C.SymKTensor(T(lam), T(u), 3)
    kn = k.normalize()
    close(np.linalg.norm(n(kn.u), axis=0), np.ones(3), RTOL)
    close(kn.full().data, k.full().data, 1e-10)
    ka = k.arrange()
    assert np.all(np.diff(np.abs(n(ka.weights))) <= 0)
    d = n(k.full().data)
    assert np.isclose(float(k.entry([1, 2, 3])), d[1, 2, 3], rtol=1e-12)
    assert float(k.score(k)) > 0.99
    k2 = C.SymKTensor.from_vec(k.tovec(), 4, 3, 3)
    np.testing.assert_array_equal(n(k2.u), n(k.u))
    assert k.permute((0, 1, 2)) is k
    assert k.ncomponents() == 3 and k.ndim == 3 and k.issymmetric()
    with x64():
        jk = JC.SymKTensor(jnp.asarray(lam), jnp.asarray(u), 3)
        want = [jk.normalize().weights, jk.normalize().u, jk.arrange().weights, jk.entry([1, 2, 3]), jk.score(jk)]
    for g_, w in zip([kn.weights, kn.u, ka.weights, k.entry([1, 2, 3]), k.score(k)], want):
        close(g_, w, RTOL)


def test_symktensor_fg_matches_dense_objective_and_autodiff():
    """@symktensor/fg.m:60-76 fast path vs the dense definition: F equals
    ‖A − full(M)‖², G equals `torch.autograd` of that F, and both equal the
    reference's fg and `jax.grad` on the same numbers."""
    g = _rng(21)
    nn, p, m = 3, 2, 3
    raw, lam, u = g.standard_normal((nn,) * m), g.standard_normal(p), g.standard_normal((nn, p))
    a = C.SymTensor(T(raw))
    model = C.SymKTensor(T(lam), T(u), m)
    f, grad = model.fg(model.fg_setup(a))
    dense_f = float(((a.data - model.full().data) ** 2).sum())
    assert np.isclose(float(f), dense_f, rtol=1e-12)

    vec = model.tovec().clone().requires_grad_(True)
    obj = ((a.data - C.SymKTensor.from_vec(vec, nn, p, m).full().data) ** 2).sum()
    (g_auto,) = torch.autograd.grad(obj, vec)
    close(grad, g_auto, 1e-10)
    with x64():
        ja = JC.SymTensor(jnp.asarray(raw))
        jm = JC.SymKTensor(jnp.asarray(lam), jnp.asarray(u), m)
        jf, jg = jm.fg(jm.fg_setup(ja))
        jauto = jax.grad(lambda v: jnp.sum((ja.data - JC.SymKTensor.from_vec(v, nn, p, m).full().data) ** 2))(jm.tovec())
    close(f, jf, RTOL)
    close(grad, jg, RTOL)
    close(g_auto, jauto, RTOL)


# ----------------------------------------------------- audit completeness


def _reference_audit():
    """The reference's audit module, loaded by file path as its own test
    loads it (importing it touches no JAX)."""
    spec = importlib.util.spec_from_file_location("toolbox_audit_ref", REPO / "tools" / "toolbox_audit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_toolbox_method_map_is_complete_and_resolves(capsys):
    """The port's audit: every method file of `docs/TOOLBOX_PARITY.md` is
    mapped, every mapped symbol resolves on the port's classes, the table
    has the reference's keys and kinds class for class, and the counts are
    the reference's 249 implemented and 31 n/a."""
    rows, n_impl, n_na, problems = toolbox_audit.audit()
    assert problems == []
    assert (n_impl, n_na) == (249, 31)
    doc = (REPO / "docs" / "TOOLBOX_PARITY.md").read_text()
    assert f"{n_impl} methods implemented, {n_na} justified n/a" in doc
    ref = _reference_audit().M
    assert list(toolbox_audit.M) == list(ref)
    for cdir, table in ref.items():
        assert set(toolbox_audit.M[cdir]) == set(table), cdir
        for meth, (kind, target, *_rest) in table.items():
            mine = toolbox_audit.M[cdir][meth]
            assert mine[0] == kind, (cdir, meth)
            if kind == "impl":
                assert mine[1] == target, (cdir, meth)  # the same class and attribute names
    assert toolbox_audit.main(["--check"]) == 0
    assert capsys.readouterr().out.strip().endswith("ok (249 impl, 31 n/a)")


def test_toolbox_audit_names_the_missing_method_table(tmp_path):
    """Outside a checkout the reference's table is absent: the audit says
    which file it needs and where, instead of failing on the read."""
    missing = tmp_path / "docs" / "TOOLBOX_PARITY.md"
    with pytest.raises(FileNotFoundError, match="TOOLBOX_PARITY.md.*checkout"):
        toolbox_audit.audit(missing)


# ------------------------------------------------------------ @sumtensor


def test_sumtensor_mttkrp_ttv(kt, sp, tt):
    k, karr = kt
    s, sarr = sp
    g = _rng(22)
    x = g.standard_normal((4, 3, 5))
    us = [g.standard_normal((sz, 2)) for sz in (4, 3, 5)]
    vs = [g.standard_normal(sz) for sz in (4, 3, 5)]
    st = C.SumTensor([C.Tensor(T(x)), k, s])
    dense = n(st.full().data)
    got = st.mttkrp([T(u) for u in us], 1)
    close(got, C.Tensor(T(dense)).mttkrp([T(u) for u in us], 1), 1e-10)
    got_ttv = st.ttv([T(v) for v in vs])
    close(got_ttv, tu.ttv(T(dense), [T(v) for v in vs]), 1e-10)
    np.testing.assert_array_equal(n((-st).full().data), -dense)
    assert not st.isscalar()
    with x64():
        jst = JC.SumTensor([JC.Tensor(jnp.asarray(x)), _jkt(karr), _jsp(sarr)])
        want = [jst.full().data, jst.mttkrp([jnp.asarray(u) for u in us], 1), jst.ttv([jnp.asarray(v) for v in vs])]
    for g_, w in zip([dense, got, got_ttv], want):
        close(g_, w, RTOL)


# ------------------------------------------- the reference's open faults


def test_symtensor_tenfun_agrees_on_symmetric_operands_and_refuses_others():
    """Fault 1 (`classes.py:1283-1286`): the reference marks every tenfun
    result presymmetrized. On symmetric operands and scalars port and
    reference agree; on a dense operand that is not symmetric the reference
    builds a SymTensor that is not symmetric, and the port raises."""
    g = _rng(23)
    raw, other = g.standard_normal((3, 3, 3)), g.standard_normal((3, 3, 3))
    x = C.SymTensor(T(raw))
    sym_other = C.SymTensor(T(other))
    with x64():
        jx, jso = JC.SymTensor(jnp.asarray(raw)), JC.SymTensor(jnp.asarray(other))
        agree = [(jx + jso).data, (jx * jso.full()).data, jx.tenfun(jnp.maximum, jso).data, (jx - 2.0).data,
                 (jx ** 2).data]
        broken = jx + JC.Tensor(jnp.asarray(other))  # a dense operand that is not symmetric
        broken_sym = bool(jsym.is_symmetric(broken.data, 1e-9))
    mine = [(x + sym_other).data, (x * sym_other.full()).data, x.tenfun(torch.maximum, sym_other).data,
            (x - 2.0).data, (x ** 2).data]
    for g_, w in zip(mine, agree):
        close(g_, w, RTOL)
    assert not broken_sym  # the reference's invariant is broken there
    for bad in (C.Tensor(T(other)), T(other), other, T(other[0])):
        with pytest.raises(ValueError, match="SymTensor.tenfun"):
            x + bad
    with pytest.raises(ValueError):
        x.tenfun(torch.maximum, C.Tensor(T(other)))


def test_symktensor_normalize_flips_no_sign_in_either_package():
    """Fault 2 (`classes.py:1455-1461`): the reference's docstring says odd
    orders flip the column sign; its code never does. The port computes the
    same numbers (and its docstring says so): at odd and even order every
    λ keeps its sign and every column its direction."""
    g = _rng(24)
    u = g.standard_normal((4, 2))
    lam = np.array([-2.0, 3.0])
    for order in (3, 4):
        k = C.SymKTensor(T(lam), T(u), order).normalize()
        with x64():
            jk = JC.SymKTensor(jnp.asarray(lam), jnp.asarray(u), order).normalize()
        close(k.weights, jk.weights, RTOL)
        close(k.u, jk.u, RTOL)
        np.testing.assert_array_equal(np.sign(n(k.weights)), np.sign(lam))
        close(k.u * torch.linalg.vector_norm(T(u), dim=0), u, RTOL)
    assert "No sign is flipped" in C.SymKTensor.normalize.__doc__


def test_sptensor_getitem_reads_scalar_tensors_where_the_reference_jit_cannot(sp):
    """Fault 3 (`classes.py:476-478`): the reference's single lookup calls
    `int(i)` and so fails on traced scalars under `jax.jit`. Eager, both
    agree; the port takes 0-d tensors as subscripts (read on the host), and
    under `jit` the reference raises."""
    s, arrays = sp
    i, j, k = (int(c) for c in n(s.coords)[0])
    with x64():
        js = _jsp(arrays)
        eager = js[i, j, k]
        with pytest.raises(jax.errors.ConcretizationTypeError):
            jax.jit(lambda a, b, c: js[a, b, c])(i, j, k)
    close(s[i, j, k], eager, RTOL)
    close(s[torch.tensor(i), torch.tensor(j), torch.tensor(k)], eager, RTOL)
