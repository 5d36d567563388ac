"""PyTorch port, Tensor Toolbox classes I: `tritd_tpu_torch.ops.classes` held
against `tritd_tpu.ops.classes`, twin for twin with `tests/test_classes.py`.

Each twin keeps the reference test's own assertion, made on the port, and
adds parity: the same numpy float64 inputs go into the JAX classes (under
`jax.enable_x64`) and the torch ones on the CPU, and the results agree to
rtol 1e-12 (closed form, `RTOL`), or to the tolerance the underlying
function was held to in `tests/test_torch_toolbox.py` (bases through
projectors). The reference's three `jax.jit` flow tests become tests that
every method keeps the device and dtype of the tensors it is given (float32
and float64). The repaired `default_device` (no quiet fall back to the CPU)
and the float32 stall of `cp_opt` from its default init are tested at the
end."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_toolbox_helpers import close, n, one_torch_thread, projector, rng, x64  # noqa: E402
from tritd_tpu.ops import classes as JC  # noqa: E402
from tritd_tpu.ops import cp_variants as jcpv  # noqa: E402
from tritd_tpu_torch.ops import classes as C  # noqa: E402
from tritd_tpu_torch.ops import cp_variants, kruskal, tenutils  # noqa: E402

RTOL = 1e-12
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def T(a, dtype=torch.float64):
    """numpy -> CPU tensor (a copy)."""
    out = torch.from_numpy(np.array(a))
    return out.to(dtype) if out.is_floating_point() else out


@pytest.fixture(scope="module")
def xy():
    g = rng(1)
    return g.standard_normal((4, 5, 6)), g.standard_normal((4, 5, 6))


def _sp_arrays(shape, nnz, seed):
    g = rng(seed)
    coords = np.stack([g.integers(0, s, nnz) for s in shape], axis=1)
    return g.random(nnz), coords


def _both_sp(shape, nnz, seed):
    vals, coords = _sp_arrays(shape, nnz, seed)
    return C.SpTensor(T(vals), T(coords), shape), JC.SpTensor(vals, coords.astype(np.int32), shape)


def _kt_arrays(seed=9):
    g = rng(seed)
    return [g.standard_normal((s, 3)) for s in (4, 5, 6)], np.abs(g.standard_normal(3)) + 0.5


def _tt_arrays(seed=11):
    g = rng(seed)
    return g.standard_normal((2, 3, 2)), [g.standard_normal((s, r)) for s, r in zip((4, 5, 6), (2, 3, 2))]


# ------------------------------------------------------------ free functions


def test_ttt_outer_contracted_inner(xy):
    x, y = xy
    a = C.Tensor(T(x))
    outer = a[:, :, 0].ttt(T(y[0]))
    np.testing.assert_allclose(n(outer.data), np.multiply.outer(x[:, :, 0], y[0]), rtol=1e-12)
    with x64():
        ja = JC.Tensor(jnp.asarray(x))
        jouter = ja[:, :, 0].ttt(jnp.asarray(y[0]))
        jcon = ja.ttt(jnp.asarray(y), adims=(1, 2))
        jin = ja.ttt(jnp.asarray(y), adims=(0, 1, 2))
    close(outer.data, jouter.data, RTOL)
    contracted = a.ttt(C.Tensor(T(y)), adims=(1, 2))
    close(contracted.data, np.einsum("ajk,bjk->ab", x, y), RTOL)
    close(contracted.data, jcon.data, RTOL)
    inner = a.ttt(T(y), adims=(0, 1, 2))
    close(inner.data, np.vdot(x, y), RTOL)
    close(inner.data, jin.data, RTOL)


def test_ttt_mixed_dims(xy):
    x, _ = xy
    b = rng(3).standard_normal((6, 3))
    out = C.Tensor(T(x)).ttt(T(b), adims=2, bdims=0)
    close(out.data, np.einsum("ijk,kl->ijl", x, b), RTOL)
    with x64():
        want = JC.Tensor(jnp.asarray(x)).ttt(jnp.asarray(b), adims=2, bdims=0).data
    close(out.data, want, RTOL)


def test_nvecs_spans_leading_subspace(xy):
    x, _ = xy
    u = n(C.Tensor(T(x)).nvecs(0, 2))
    u_svd = np.linalg.svd(x.reshape(4, -1), full_matrices=False)[0][:, :2]
    np.testing.assert_allclose(np.abs(u.T @ u_svd), np.eye(2), atol=1e-10)
    mx = np.argmax(np.abs(u), axis=0)
    assert all(u[mx[j_], j_] > 0 for j_ in range(2))
    with x64():
        want = JC.Tensor(jnp.asarray(x)).nvecs(0, 2)
    close(projector(u), projector(want), 1e-10)
    close(u, want, 1e-10)  # flipsign fixes the sign: equal column for column


def test_collapse_contract_scale(xy):
    x, _ = xy
    t = C.Tensor(T(x))
    with x64():
        jt = JC.Tensor(jnp.asarray(x))
        want = {
            "sum1": jt.collapse((1,)).data, "max02": jt.collapse((0, 2), jnp.max).data,
            "all": jt.collapse(), "excl2": jt.collapse(-2).data,
            "trace": JC.Tensor(jnp.asarray(x[:, :4, :])).contract(0, 1).data,
            "scale1": jt.scale(jnp.arange(1.0, 6.0), 1).data,
            "scale20": jt.scale(jnp.asarray(rng(4).standard_normal((6, 4))), (2, 0)).data,
        }
    close(t.collapse((1,)).data, x.sum(axis=1), RTOL)
    close(t.collapse((1,)).data, want["sum1"], RTOL)
    close(t.collapse((0, 2), torch.amax).data, want["max02"], RTOL)
    whole = t.collapse()
    assert isinstance(whole, torch.Tensor) and whole.ndim == 0
    close(whole, want["all"], RTOL)
    close(t.collapse(-2).data, want["excl2"], RTOL)  # the toolbox's exclusion convention
    close(C.Tensor(T(x[:, :4, :])).contract(0, 1).data, want["trace"], RTOL)
    close(t.scale(torch.arange(1.0, 6.0, dtype=torch.float64), 1).data, want["scale1"], RTOL)
    close(t.scale(T(rng(4).standard_normal((6, 4))), (2, 0)).data, want["scale20"], RTOL)
    with pytest.raises(ValueError):
        t.contract(0, 1)  # unequal sizes
    with pytest.raises(ValueError):
        t.scale(torch.arange(1.0, 6.0, dtype=torch.float64), 0)  # size mismatch


def test_tensor_find_divide_end_indexing():
    """`@tensor/{find,mldivide,mrdivide,end}.m` surface."""
    arr = np.zeros((3, 4, 2))
    arr[1, 2, 0] = 5.0
    arr[2, 0, 1] = -3.0
    t = C.Tensor(arr, device=CPU)
    subs, vals = t.find()
    assert subs.dtype == torch.int64
    assert sorted(map(tuple, subs.tolist())) == [(1, 2, 0), (2, 0, 1)]
    with x64():
        jsubs, jvals = JC.Tensor(jnp.asarray(arr)).find()
    np.testing.assert_array_equal(n(subs), jsubs)  # the same row-major order
    np.testing.assert_array_equal(n(vals), jvals)
    np.testing.assert_allclose(n(t.mldivide(2.0).data), arr / 2.0)
    np.testing.assert_allclose(n(t.mrdivide(2.0).data), arr / 2.0)
    np.testing.assert_allclose(np.asarray(t[-1]), arr[-1])  # X(end,:,:) == X[-1], via __array__
    sp = C.SpTensor(np.array([5.0, -3.0]), np.array([[1, 2, 0], [2, 0, 1]]), (3, 4, 2), device=CPU)
    c, v = sp.find()
    np.testing.assert_array_equal(n(c), [[1, 2, 0], [2, 0, 1]])
    np.testing.assert_allclose(n(v), [5.0, -3.0])


# ------------------------------------------------------------------- Tensor


def test_tensor_arithmetic_and_comparisons(xy):
    x, y = xy
    a, b = C.Tensor(T(x)), C.Tensor(T(y))
    with x64():
        ja, jb = JC.Tensor(jnp.asarray(x)), JC.Tensor(jnp.asarray(y))
        want = [(ja + jb).data, (ja - 2.0).data, (3.0 * ja).data, (ja * jb).data,
                (ja / (abs(jb) + 1)).data, (-ja).data, (ja ** 2).data, (2.0 / (abs(ja) + 1)).data,
                (1.0 - ja).data, ja.exp().data]
    got = [(a + b).data, (a - 2.0).data, (3.0 * a).data, (a * b).data, (a / (abs(b) + 1)).data,
           (-a).data, (a ** 2).data, (2.0 / (abs(a) + 1)).data, (1.0 - a).data, a.exp().data]
    for g_, w_ in zip(got, want):
        close(g_, w_, RTOL)
    np.testing.assert_array_equal(n((a + b).data), x + y)
    assert bool(torch.all((a == a).data))
    assert (a < b).data.dtype == torch.bool
    for op in ("__lt__", "__le__", "__gt__", "__ge__", "__ne__", "logical_and", "logical_or", "logical_xor"):
        with x64():
            jw = np.asarray(getattr(ja, op)(jb).data)
        np.testing.assert_array_equal(n(getattr(a, op)(b).data), jw, err_msg=op)
    assert bool(a.isequal(C.Tensor(T(x))))
    assert not bool(a.isequal(b))
    assert not bool(a.isequal(T(x[:, :, :2])))
    assert a[1:3, :, 0].shape == (2, 5)
    np.testing.assert_array_equal(n(a.permute((2, 0, 1)).data), np.transpose(x, (2, 0, 1)))
    assert C.Tensor(T(x[:, :1, :])).squeeze().shape == (4, 6)
    np.testing.assert_array_equal(n(a.logical_not().data), x == 0)
    assert int(a.nnz()) == x.size and a.ndim == 3 and not a.isscalar()


def test_tensor_methods_match_functional(xy):
    x, _ = xy
    g = rng(5)
    u, v = g.standard_normal((3, 5)), g.standard_normal(5)
    fs = [g.standard_normal((s, 3)) for s in x.shape]
    w = (x > 0).astype(np.float64)
    t = C.Tensor(T(x))
    with x64():
        jt = JC.Tensor(jnp.asarray(x))
        want = {
            "norm": jt.norm(), "ttm": jt.ttm(jnp.asarray(u), 1).data, "ttv": jt.ttv(jnp.asarray(v), 1).data,
            "mttkrp": jt.mttkrp([jnp.asarray(f) for f in fs], 0), "inner": jt.innerprod(JC.Tensor(jnp.asarray(x))),
            "tenfun": jt.tenfun(jnp.maximum, JC.Tensor(-jnp.asarray(x))).data,
            "mask": jt.mask(jnp.asarray(w)),
        }
    close(t.norm(), np.linalg.norm(x.ravel()), RTOL)
    close(t.norm(), want["norm"], RTOL)
    close(t.ttm(T(u), 1).data, want["ttm"], RTOL)
    close(t.ttm(u, 1).data, want["ttm"], RTOL)  # a numpy operand joins the tensor's device and dtype
    close(t.ttv(T(v), 1).data, want["ttv"], RTOL)
    close(t.mttkrp([T(f) for f in fs], 0), want["mttkrp"], RTOL)
    close(t.innerprod(C.Tensor(T(x))), want["inner"], RTOL)
    close(t.tenfun(torch.maximum, C.Tensor(-T(x))).data, want["tenfun"], RTOL)
    close(t.mask(T(w)), x.ravel()[w.ravel() > 0], RTOL)
    close(t.mask(T(w)), want["mask"], RTOL)


def _tensors_of(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors_of(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors_of(o)
    elif obj is not None and not isinstance(obj, (bool, int, float, np.ndarray)):
        yield from _tensors_of([v for k, v in vars(obj).items() if isinstance(v, (torch.Tensor, list))])


def _keeps(outs, dtype, device=CPU):
    """Every tensor in `outs` (class instances opened up) lies on `device`,
    and every floating one is of `dtype`."""
    seen = 0
    for ten in _tensors_of(outs):
        assert ten.device.type == device, ten.device
        if ten.is_floating_point():
            assert ten.dtype == dtype, ten.dtype
            seen += 1
    assert seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tensor_keeps_device_and_dtype(xy, dtype):
    """Twin of the reference's jit flow test: `(t * 2 + 1).permute` and the
    rest of the Tensor surface stay on the tensor's device and dtype."""
    x, _ = xy
    t = C.Tensor(T(x, dtype))
    out = (t * 2.0 + 1.0).permute((1, 0, 2))
    assert isinstance(out, C.Tensor)
    close(out.data.double(), np.transpose(2 * x + 1, (1, 0, 2)), 1e-6 if dtype == torch.float32 else RTOL)
    g = rng(6)
    fs = [g.standard_normal((s, 2)) for s in x.shape]
    _keeps([out, t.norm(), t.ttm(g.standard_normal((3, 5)), 1), t.ttv(g.standard_normal(6), 2),
            t.mttkrps(fs), t.nvecs(1, 2), t.collapse((0,)), t.scale(np.arange(1.0, 6.0), 1),
            t.innerprod(t), t[:, :4, :4].symmetrize(), t.with_set((0, 0, 0), 3.0),
            t.to_tenmat((1,)).data, t.exp(), abs(-t)], dtype)


# ----------------------------------------------------------------- SpTensor


@pytest.fixture(scope="module")
def sps():
    return _both_sp((5, 6, 7), 30, 7)


def test_sptensor_roundtrip_and_numerics(sps):
    sp, jsp = sps
    g = rng(20)
    fs = [g.standard_normal((s, 2)) for s in sp.shape]
    v = g.standard_normal(6)
    dense = n(sp.double())
    with x64():
        jsp = JC.SpTensor(jnp.asarray(n(sp.vals)), jnp.asarray(n(sp.coords)), sp.shape)
        want = {"dense": jsp.double(), "norm": jsp.norm(), "inner": jsp.innerprod(JC.Tensor(jsp.double())),
                "mttkrp": jsp.mttkrp([jnp.asarray(f) for f in fs], 1), "ttv": jsp.ttv(jnp.asarray(v), 1).data}
    close(dense, want["dense"], RTOL)
    close(sp.norm(), np.linalg.norm(dense.ravel()), RTOL)
    close(sp.norm(), want["norm"], RTOL)
    close(sp.innerprod(C.Tensor(T(dense))), want["inner"], RTOL)
    close(sp.innerprod(sp), np.vdot(dense, dense), RTOL)
    close(sp.mttkrp([T(f) for f in fs], 1), want["mttkrp"], RTOL)
    close(sp.ttv(T(v), 1).data, want["ttv"], RTOL)


def test_sptensor_arithmetic(sps):
    sp, _ = sps
    dense = n(sp.double())
    with x64():
        jsp = JC.SpTensor(jnp.asarray(n(sp.vals)), jnp.asarray(n(sp.coords)), sp.shape)
        want = [(2.0 * jsp).double(), (jsp + jsp).double(), (jsp - jsp).double(), abs(jsp).double(),
                (jsp * jsp).double(), jsp.permute((2, 0, 1)).double(), (jsp + jsp).coalesce().double()]
        jco = (jsp + jsp).coalesce()
    co = (sp + sp).coalesce()
    got = [(2.0 * sp).double(), (sp + sp).double(), (sp - sp).double(), abs(sp).double(),
           (sp * sp).double(), sp.permute((2, 0, 1)).double(), co.double()]
    for g_, w_ in zip(got, want):
        close(g_, w_, RTOL, atol=1e-12)
    close(got[1], 2.0 * dense, RTOL)
    assert co.nnz <= 2 * sp.nnz and co.nnz == jco.nnz
    np.testing.assert_array_equal(n(co.coords), np.asarray(jco.coords))  # sorted by linear index
    close(co.vals, jco.vals, RTOL)


def test_sptenmat_roundtrip(sps):
    sp, _ = sps
    m = sp.to_sptenmat((2, 0))
    assert isinstance(m, C.SpTenMat) and m.row_idx.dtype == torch.int64
    dense = n(sp.double())
    close(m.double(), np.transpose(dense, (2, 0, 1)).reshape(7 * 5, 6), RTOL)
    with x64():
        jm = JC.SpTensor(jnp.asarray(n(sp.vals)), jnp.asarray(n(sp.coords)), sp.shape).to_sptenmat((2, 0))
        np.testing.assert_array_equal(n(m.row_idx), np.asarray(jm.row_idx))
        np.testing.assert_array_equal(n(m.col_idx), np.asarray(jm.col_idx))
    back = m.to_sptensor()
    np.testing.assert_array_equal(n(back.coords), n(sp.coords))
    close(back.double(), dense, RTOL)


# ------------------------------------------------------------------ KTensor


@pytest.fixture(scope="module")
def kts():
    fs, w = _kt_arrays()
    return C.KTensor([T(u) for u in fs], T(w)), (fs, w)


def test_ktensor_numerics(kts, xy):
    kt, (fs, w) = kts
    x, _ = xy
    g = rng(30)
    vfs = [g.standard_normal((s, 2)) for s in kt.shape]
    v = g.standard_normal(5)
    ones = [np.ones(s) for s in kt.shape]
    dense = n(kt.double())
    with x64():
        jk = JC.KTensor([jnp.asarray(u) for u in fs], jnp.asarray(w))
        want = {"dense": jk.double(), "norm": jk.norm(), "inner_x": jk.innerprod(JC.Tensor(jnp.asarray(x))),
                "inner_k": jk.innerprod(jk), "mttkrp": jk.mttkrp([jnp.asarray(f) for f in vfs], 2),
                "ttv": jk.ttv(jnp.asarray(v), 1).double(),
                "all": jk.ttv([jnp.asarray(o) for o in ones], (0, 1, 2))}
    close(dense, np.einsum("ir,jr,kr,r->ijk", *fs, w), RTOL)
    close(dense, want["dense"], RTOL)
    close(kt.norm(), np.linalg.norm(dense.ravel()), 1e-10)
    close(kt.norm(), want["norm"], RTOL)
    close(kt.innerprod(C.Tensor(T(x))), want["inner_x"], RTOL)
    close(C.Tensor(T(x)).innerprod(kt), want["inner_x"], RTOL)  # the dense side dispatches
    close(kt.innerprod(kt), want["inner_k"], RTOL)
    close(kt.mttkrp([T(f) for f in vfs], 2), want["mttkrp"], RTOL)
    close(kt.ttv(T(v), 1).double(), want["ttv"], RTOL)
    full_contract = kt.ttv([T(o) for o in ones], (0, 1, 2))
    close(full_contract, dense.sum(), 1e-10)
    close(full_contract, want["all"], RTOL)


def test_ktensor_transforms_preserve_full(kts):
    kt, (fs, w) = kts
    dense = n(kt.double())
    with x64():
        jk = JC.KTensor([jnp.asarray(u) for u in fs], jnp.asarray(w))
        jt = [jk.normalize(), jk.arrange(), jk.fixsigns(), jk.redistribute(1)]
        jwant = [(np.asarray(k.weights), [np.asarray(u) for u in k.factors]) for k in jt]
        jperm = jk.permute((2, 1, 0)).double()
        jscore = jk.score(jk)
    for k, (jw, jf) in zip((kt.normalize(), kt.arrange(), kt.fixsigns(), kt.redistribute(1)), jwant):
        close(k.double(), dense, 1e-10)
        close(k.weights, jw, RTOL)
        for u, ju in zip(k.factors, jf):
            close(u, ju, RTOL)
    assert kt.arrange().weights[0] >= kt.arrange().weights[-1]
    close(kt.permute((2, 1, 0)).double(), np.transpose(dense, (2, 1, 0)), RTOL)
    close(kt.permute((2, 1, 0)).double(), jperm, RTOL)
    close(kt.score(kt), 1.0, 1e-10)
    close(kt.score(kt), jscore, RTOL)


def test_ktensor_plus_concat_and_vec_roundtrip(kts):
    kt, (fs, w) = kts
    both = kt + kt
    assert both.ncomponents() == 6
    close(both.double(), 2 * n(kt.double()), RTOL)
    close((kt - kt).double(), np.zeros(kt.shape), RTOL, atol=1e-12)
    close((2.0 * kt).double(), 2 * n(kt.double()), RTOL)
    vec = kt.tovec()
    with x64():
        jvec = JC.KTensor([jnp.asarray(u) for u in fs], jnp.asarray(w)).tovec()
    np.testing.assert_array_equal(n(vec), np.asarray(jvec))  # the same layout
    back = C.KTensor.from_vec(vec, kt.shape, kt.ncomponents())
    np.testing.assert_array_equal(n(back.double()), n(kt.double()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_ktensor_keeps_device_and_dtype(kts, dtype):
    """Twin of the reference's jit flow test: `k.normalize().norm()` and the
    rest of the KTensor surface stay on the device and dtype."""
    _, (fs, w) = kts
    k = C.KTensor([T(u, dtype) for u in fs], T(w, dtype))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    close(k.normalize().norm(), n(k.norm()), tol)
    g = rng(31)
    vfs = [g.standard_normal((s, 2)) for s in k.shape]
    _keeps([k.normalize(), k.arrange(), k.fixsigns(), k.redistribute(0), k.full(), k.norm(), k.tovec(),
            k.mttkrp(vfs, 1), k.ttv(g.standard_normal(5), 1), k.ttm(g.standard_normal((3, 4)), 0),
            k.nvecs(0, 2), k.extract([0, 2]), k + k, -k, 2.0 * k,
            k.update([-1, 0, 1, 2], k.tovec()), k.entries_at(torch.zeros((2, 3), dtype=torch.int64))], dtype)


# ------------------------------------------------------------------ TTensor


def test_ttensor_numerics(xy):
    x, _ = xy
    core, fs = _tt_arrays()
    tt = C.TTensor(T(core), [T(u) for u in fs])
    g = rng(12)
    u, v = g.standard_normal((7, 5)), g.standard_normal(5)
    mfs = [g.standard_normal((s, 2)) for s in tt.shape]
    ones = [np.ones(s) for s in tt.shape]
    dense = n(tt.double())
    with x64():
        jt = JC.TTensor(jnp.asarray(core), [jnp.asarray(f) for f in fs])
        want = {"dense": jt.double(), "norm": jt.norm(), "inner": jt.innerprod(JC.Tensor(jnp.asarray(x))),
                "ttm": jt.ttm(jnp.asarray(u), 1).double(), "ttv": jt.ttv(jnp.asarray(v), 1).double(),
                "all": jt.ttv([jnp.asarray(o) for o in ones], (0, 1, 2)),
                "mttkrp": jt.mttkrp([jnp.asarray(f) for f in mfs], 0)}
    close(dense, want["dense"], RTOL)
    close(tt.norm(), np.linalg.norm(dense.ravel()), 1e-10)
    close(tt.norm(), want["norm"], RTOL)
    close(tt.innerprod(C.Tensor(T(x))), want["inner"], RTOL)
    close(tt.innerprod(tt), np.vdot(dense, dense), 1e-10)
    close(tt.ttm(T(u), 1).double(), want["ttm"], RTOL)
    close(tt.ttv(T(v), 1).double(), want["ttv"], RTOL)
    close(tt.ttv([T(o) for o in ones], (0, 1, 2)), dense.sum(), 1e-10)
    close(tt.ttv([T(o) for o in ones], (0, 1, 2)), want["all"], RTOL)
    close(tt.mttkrp([T(f) for f in mfs], 0), want["mttkrp"], RTOL)


# ------------------------------------------------- SymTensor / SymKTensor


def test_symtensor_and_symktensor():
    g = rng(14)
    a, v = g.standard_normal((4, 4, 4)), g.standard_normal(4)
    u, w = g.standard_normal((4, 2)), np.array([1.5, -0.5])
    st = C.SymTensor(T(a))
    assert bool(st.issymmetric())
    gv = st.ttsv(T(v), keep=1)
    assert gv.shape == (4,)
    sk = C.SymKTensor(T(w), T(u), 3)
    dense = n(sk.double())
    close(dense, np.einsum("ir,jr,kr,r->ijk", u, u, u, w), RTOL)
    close(sk.norm(), np.linalg.norm(dense.ravel()), 1e-10)
    assert bool(sk.full().issymmetric())
    with x64():
        jst = JC.SymTensor(jnp.asarray(a))
        jsk = JC.SymKTensor(jnp.asarray(w), jnp.asarray(u), 3)
        want = {"data": jst.data, "ttsv": jst.ttsv(jnp.asarray(v), keep=1), "dense": jsk.double(),
                "norm": jsk.norm()}
    close(st.data, want["data"], RTOL)
    close(gv, want["ttsv"], RTOL)
    close(dense, want["dense"], RTOL)
    close(sk.norm(), want["norm"], RTOL)


# ---------------------------------------------------------------- SumTensor


def test_sumtensor_mixed_parts(kts, sps):
    kt, (fs, w) = kts
    sp, _ = sps
    st = C.SumTensor([C.Tensor(torch.zeros(kt.shape, dtype=torch.float64))]) + kt
    assert len(st.parts) == 2
    close(st.double(), n(kt.double()), RTOL)
    probe = C.Tensor(torch.ones(kt.shape, dtype=torch.float64))
    close(st.innerprod(probe), n(kt.double()).sum(), 1e-10)
    close(st.norm(), n(kt.norm()), 1e-10)
    with x64():
        jk = JC.KTensor([jnp.asarray(u) for u in fs], jnp.asarray(w))
        jst = JC.SumTensor([JC.Tensor(jnp.zeros(jk.shape))]) + jk
        want = {"inner": jst.innerprod(JC.Tensor(jnp.ones(jk.shape))), "norm": jst.norm()}
    close(st.innerprod(probe), want["inner"], RTOL)
    close(st.norm(), want["norm"], RTOL)


# ------------------------------------------------------------------- TenMat


def test_tenmat_roundtrip_and_transpose(xy):
    x, _ = xy
    m = C.TenMat.from_tensor(T(x), (2, 0))
    assert m.shape == (6 * 4, 5) and m.tsize() == (4, 5, 6)
    with x64():
        jm = JC.TenMat.from_tensor(jnp.asarray(x), (2, 0))
    np.testing.assert_array_equal(n(m.data), np.asarray(jm.data))  # the same column order
    np.testing.assert_array_equal(n(m.to_tensor().data), x)
    mt = m.T
    assert mt.shape == (5, 24)
    np.testing.assert_array_equal(n(mt.to_tensor().data), x)
    close(m.norm(), np.linalg.norm(x.ravel()), RTOL)
    np.testing.assert_array_equal(n((m - m).double()), np.zeros(m.shape))
    np.testing.assert_array_equal(n((m + m).double()), 2 * n(m.double()))


def test_tenmat_mtimes(xy):
    x, _ = xy
    a = C.TenMat.from_tensor(T(x), (0,))
    prod = a * a.T
    assert isinstance(prod, C.TenMat) and prod.tsize() == (4, 4)
    xn = x.reshape(4, -1)
    close(prod.double(), xn @ xn.T, RTOL)
    with x64():
        ja = JC.TenMat.from_tensor(jnp.asarray(x), (0,))
        jp = ja * ja.T
    assert (prod.row_modes, prod.col_modes, prod.tshape) == (jp.row_modes, jp.col_modes, jp.tshape)
    close(prod.double(), jp.data, RTOL)
    np.testing.assert_array_equal(n((2.0 * a).double()), 2 * n(a.double()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tensor_to_tenmat_keeps_device_and_dtype(xy, dtype):
    """Twin of the reference's `to_tenmat` + jit test: the matricization,
    `(mm * 3).to_tensor()` and the TenMat surface keep device and dtype."""
    x, _ = xy
    t = C.Tensor(T(x, dtype))
    m = t.to_tenmat((1,))
    np.testing.assert_array_equal(n(m.double()), n(T(x, dtype)).transpose(1, 0, 2).reshape(5, 24))
    out = (m * 3.0).to_tensor()
    assert isinstance(out, C.Tensor)
    close(out.data.double(), 3 * n(T(x, dtype)).astype(np.float64), 1e-6 if dtype == torch.float32 else RTOL)
    _keeps([m, m.T, m + m, -m, m * m.T, m.with_set((0, 0), 7.0), m.norm(), out], dtype)


# -------------------------------------------------- default device (repair)


def test_default_device_needs_cuda_or_an_explicit_device():
    """`default_device(None)` is the card; without CUDA it raises instead of
    building on the CPU. Explicit devices still work."""
    assert kruskal.default_device("cpu") == torch.device("cpu")
    x = tenutils.tenzeros((2, 3), device="cpu")
    assert x.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None is the card here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        kruskal.default_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kruskal.tenrand(None, (2, 3))


def test_a_class_built_from_numpy_needs_cuda_or_an_explicit_device():
    arr = np.ones((2, 3, 4))
    assert C.Tensor(arr, device="cpu").data.device.type == "cpu"
    assert C.Tensor(torch.ones(2, 3)).data.device.type == "cpu"  # a tensor keeps its device
    k = C.KTensor([torch.ones(2, 1, dtype=torch.float64)] * 3, np.ones(1))  # numpy weights follow it
    assert k.weights.device.type == "cpu" and k.weights.dtype == torch.float64
    assert C.Tensor(arr, device="cpu", dtype=torch.float32).data.dtype == torch.float32
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: device=None is the card here")
    for build in (lambda: C.Tensor(arr), lambda: C.SpTensor(np.ones(1), np.zeros((1, 3), int), (2, 2, 2)),
                  lambda: C.KTensor([np.ones((2, 1))] * 3), lambda: C.SymTensor(arr[:2, :2, :2]),
                  lambda: C.TenMat.from_tensor(arr, (0,))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()


# ---------------------------------------- cp_opt in float32 (ROADMAP fault 2)


def _cp_problem(shape=(60, 70, 80), rank=5, seed=18):
    g = rng(seed)
    truth = [g.random((s, rank)) + 0.1 for s in shape]
    clean = np.einsum("ir,jr,kr->ijk", *truth)
    nz = g.standard_normal(shape)
    x = clean + 0.1 * np.linalg.norm(clean) / np.linalg.norm(nz) * nz
    return x, [0.1 * g.standard_normal((s, rank)) for s in shape]


def test_cp_opt_float32_leaves_the_default_init_as_the_reference_does():
    """From the default 0.1·normal init at 60×70×80, R = 5, the first steps
    change a loss of about 1 by less than float32 resolves. The reference's
    L-BFGS (optax, whose zoom line search takes Hager and Zhang's
    approximate decrease) leaves that saddle in float32; the port's did not
    while it ran `torch.optim.LBFGS` (loss 1.000005 after 200 iterations).
    The repaired port leaves it as the reference and float64 do: after 30
    iterations all three losses are below 0.1 (the start is 1), and the
    weighted variant too."""
    x, init = _cp_problem()
    f32 = [u.astype(np.float32) for u in init]
    jres = jcpv.cp_opt(jnp.asarray(x, jnp.float32), 5, max_iters=30, tol=0.0,
                       init_factors=[jnp.asarray(u) for u in f32])
    pres = cp_variants.cp_opt(T(x, torch.float32), 5, max_iters=30, tol=0.0,
                              init_factors=[T(u, torch.float32) for u in init])
    wide = cp_variants.cp_opt(T(x), 5, max_iters=30, tol=0.0, init_factors=[T(u) for u in init])
    losses = [(1.0 - float(r["fit"])) ** 2 for r in (jres, pres, wide)]
    assert max(losses) < 0.1, losses
    assert pres["fit"].dtype == torch.float32 and pres["n_iters"] == 30
    w = (rng(3).random(x.shape) > 0.3).astype(np.float64)
    pw = cp_variants.cp_wopt(T(x, torch.float32), T(w, torch.float32), 5, max_iters=30, tol=0.0,
                             init_factors=[T(u, torch.float32) for u in init])
    assert (1.0 - float(pw["fit"])) ** 2 < 0.1
