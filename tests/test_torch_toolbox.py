"""PyTorch port, Tensor Toolbox surface II: `ops/{tenutils,sparse,symmetric,
cp_variants}.py` held against their JAX counterparts in `tritd_tpu/ops/`.

The class layout is that of `tests/test_tensor_toolbox.py`, test for test:
each twin keeps the reference test's own assertion, made on the port, and
adds parity — the same numpy float64 inputs through the JAX function (under
`jax.enable_x64`) and the torch one on the CPU.

Tolerances: rtol 1e-10 for closed-form functions; 1e-8 for iterative ones,
which start from an injected point and must return the reference's
`n_iters`. `n_iters` is compared where the stopping quantity is the
algorithm's and not rounding noise (data with noise; see
`test_torch_kruskal_decomp.py::_noisy`). Bases are compared through
projectors. `gcp_opt` and `cp_sym` (Adam on both sides) follow the reference
step for step: the first 20 objective values to 1e-8. `cp_opt`/`cp_wopt`
(two different L-BFGS line searches) are held on loss and gradient at given
points to 1e-10 and on the reference test's bar for the result. `cp_arls`
draws its samples inside the loop: one mode solve is held to a numpy
normal-equation solve on given indices, the whole to the reference's bar."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_toolbox_helpers import (  # noqa: E402
    RTOL_CLOSED,
    RTOL_ITER,
    close,
    j,
    jl,
    n,
    np_ktensor_full,
    np_symmetrize,
    one_torch_thread,
    projector,
    random_factors,
    rng,
    t,
    tl,
    x64,
)
from tritd_tpu.ops import cp_variants as jcpv  # noqa: E402
from tritd_tpu.ops import decomp as jdecomp  # noqa: E402
from tritd_tpu.ops import kruskal as jkruskal  # noqa: E402
from tritd_tpu.ops import sparse as jsparse  # noqa: E402
from tritd_tpu.ops import symmetric as jsym  # noqa: E402
from tritd_tpu.ops import tenutils as jtu  # noqa: E402
from tritd_tpu_torch import interop  # noqa: E402
from tritd_tpu_torch.ops import (  # noqa: E402
    cp_apr,
    cp_arls,
    cp_nmu,
    cp_opt,
    cp_sym,
    cp_wopt,
    create_problem_binary,
    eig_geap,
    eig_sshopm,
    eig_sshopmc,
    export_data,
    gcp_opt,
    import_data,
    is_symmetric,
    khatrirao,
    ktensor_arrange,
    ktensor_fixsigns,
    ktensor_full,
    ktensor_innerprod,
    ktensor_norm,
    ktensor_score,
    matrandcong,
    matrandnorm,
    matrandorth,
    mttkrp,
    sp_full,
    sp_ind2sub,
    sp_innerprod,
    sp_mttkrp,
    sp_norm,
    sp_sub2ind,
    sp_ttv,
    sptendiag,
    sptenmat,
    sptenrand,
    sumtensor_full,
    symktensor_full,
    symmetrize,
    tendiag,
    teneye,
    tenmat,
    tenones,
    tenrandblk,
    tenzeros,
    ttensor_full,
    ttensor_norm,
    ttm,
    ttsv,
    ttv,
    tucker_sym,
    tucker_ttm,
)
from tritd_tpu_torch.ops import cp_variants, sparse, tenutils  # noqa: E402

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _sp(shape, nnz, seed=0, duplicate=False):
    """A random COO tensor as numpy: float64 values, int64 coordinates."""
    g = rng(seed)
    coords = np.stack([g.integers(0, s, nnz) for s in shape], axis=1)
    if duplicate:
        coords[1] = coords[0]
    return g.random(nnz), coords, tuple(shape)


def _tsp(sp):
    return interop.sptensor_from_numpy(*sp, dtype=F64, device="cpu")


def _jsp(sp):
    vals, coords, shape = sp
    return jnp.asarray(vals), jnp.asarray(coords, jnp.int32), shape


# ------------------------------------------------------------------- sparse


class TestSparse:
    def test_sub2ind_roundtrip(self):
        shape = (3, 4, 5)
        coords = np.array([[0, 0, 0], [2, 3, 4], [1, 2, 3]])
        tc = torch.from_numpy(coords)
        idx = sp_sub2ind(tc, shape)
        back = sp_ind2sub(idx, shape)
        np.testing.assert_array_equal(n(back), coords)
        # row-major convention: last mode fastest
        assert int(idx[0]) == 0 and int(idx[1]) == 3 * 4 * 5 - 1
        assert idx.dtype == torch.int64 and back.dtype == torch.int64
        ref_idx = jsparse.sp_sub2ind(jnp.asarray(coords, jnp.int32), shape)
        np.testing.assert_array_equal(n(idx), n(ref_idx))
        np.testing.assert_array_equal(n(back), n(jsparse.sp_ind2sub(ref_idx, shape)))

    def test_full_accumulates_duplicates(self):
        sp = (np.array([1.0, 2.0, 5.0]), np.array([[0, 1], [0, 1], [1, 0]]), (2, 2))
        d = sp_full(*_tsp(sp))
        np.testing.assert_allclose(n(d), np.array([[0.0, 3.0], [5.0, 0.0]]))
        with x64():
            ref = n(jsparse.sp_full(*_jsp(sp)))
        close(d, ref, rtol=RTOL_CLOSED)

    def test_sptenrand_and_norm(self):
        vals, coords, shape = sptenrand(_gen(), (6, 7, 8), nnz=40, device="cpu")
        assert tuple(vals.shape) == (40,) and tuple(coords.shape) == (40, 3)
        assert coords.dtype == torch.int64 and shape == (6, 7, 8)
        sparse.check_coords(coords, shape)  # valid by construction
        dense = sp_full(vals, coords, shape)
        np.testing.assert_allclose(
            float(sp_norm(vals, coords, shape)), float(torch.linalg.vector_norm(dense)), rtol=1e-6
        )
        # parity of the dense branch (numel <= 4 nnz) with duplicates
        sp = _sp((4, 5, 6), 40, seed=1, duplicate=True)
        with x64():
            ref = float(jsparse.sp_norm(*_jsp(sp)))
        np.testing.assert_allclose(float(sp_norm(*_tsp(sp))), ref, rtol=RTOL_CLOSED)

    def test_sp_norm_large_shape_path(self):
        # total size >> nnz triggers the sorted segment-sum path
        sp = _sp((30, 31, 32), 10, seed=2, duplicate=True)
        tsp = _tsp(sp)
        dense = sp_full(*tsp)
        got = float(sp_norm(*tsp))
        np.testing.assert_allclose(got, float(torch.linalg.vector_norm(dense)), rtol=1e-12)
        # the duplicate's two positive values were added before squaring
        assert got > float(torch.linalg.vector_norm(tsp[0]))
        with x64():
            ref = float(jsparse.sp_norm(*_jsp(sp)))
        np.testing.assert_allclose(got, ref, rtol=RTOL_CLOSED)

    def test_sptendiag(self):
        v = np.array([1.0, 2.0, 3.0])
        vals, coords, shape = sptendiag(t(v))
        dense = sp_full(vals, coords, shape)
        np.testing.assert_allclose(n(dense), n(tendiag(t(v))))
        with x64():
            ref = n(jsparse.sp_full(*jsparse.sptendiag(j(v), (3, 4))))
        close(sp_full(*sptendiag(t(v), (3, 4))), ref, rtol=RTOL_CLOSED)
        # the reference drops what does not fit; the port refuses it on the host
        with pytest.raises(IndexError):
            sptendiag(t(v), (2, 3))

    def test_innerprod_matches_dense(self):
        sp = _sp((5, 6, 7), 25, seed=3, duplicate=True)
        other = rng(4).standard_normal(sp[2])
        got = float(sp_innerprod(*_tsp(sp), t(other)))
        want = float((sp_full(*_tsp(sp)) * t(other)).sum())
        # duplicates: innerprod gathers per-nonzero so duplicates also work
        np.testing.assert_allclose(got, want, rtol=1e-12)
        with x64():
            ref = float(jsparse.sp_innerprod(*_jsp(sp), j(other)))
        np.testing.assert_allclose(got, ref, rtol=RTOL_CLOSED)

    def test_ttv_matches_dense(self):
        sp = _sp((4, 5, 6), 30, seed=5)
        g = rng(6)
        v0, v1, v2 = g.standard_normal(4), g.standard_normal(5), g.standard_normal(6)
        dense = n(sp_full(*_tsp(sp)))
        got = sp_ttv(*_tsp(sp), [t(v1)], [1])
        close(got, np.einsum("ijk,j->ik", dense, v1), rtol=1e-12)
        # all-modes contraction -> scalar
        s = sp_ttv(*_tsp(sp), tl([v0, v1, v2]), [0, 1, 2])
        np.testing.assert_allclose(
            float(s), float(np.einsum("ijk,i,j,k->", dense, v0, v1, v2)), rtol=1e-12
        )
        with x64():
            ref = n(jsparse.sp_ttv(*_jsp(sp), [j(v1)], [1]))
            ref2 = n(jsparse.sp_ttv(*_jsp(sp), jl([v2, v0]), [2, 0]))
            ref_s = float(jsparse.sp_ttv(*_jsp(sp), jl([v0, v1, v2]), [0, 1, 2]))
        close(got, ref, rtol=RTOL_CLOSED)
        close(sp_ttv(*_tsp(sp), tl([v2, v0]), [2, 0]), ref2, rtol=RTOL_CLOSED)
        np.testing.assert_allclose(float(s), ref_s, rtol=RTOL_CLOSED)

    def test_sp_mttkrp_matches_dense(self):
        sp = _sp((4, 5, 6), 35, seed=7, duplicate=True)
        factors = random_factors(sp[2], 3, seed=8)
        dense = sp_full(*_tsp(sp))
        for mode in range(3):
            got = sp_mttkrp(*_tsp(sp), tl(factors), mode)
            close(got, mttkrp(dense, tl(factors), mode), rtol=1e-12)
            with x64():
                ref = n(jsparse.sp_mttkrp(*_jsp(sp), jl(factors), mode))
            close(got, ref, rtol=RTOL_CLOSED)

    def test_sptenmat_matches_tenmat(self):
        sp = _sp((4, 5, 6), 20, seed=9)
        dense = sp_full(*_tsp(sp))
        mv, (ri, ci), (nr, nc) = sptenmat(*_tsp(sp), (1,))
        mat = torch.zeros((nr, nc), dtype=F64).index_put_((ri, ci), mv, accumulate=True)
        np.testing.assert_allclose(n(mat), n(tenmat(dense, (1,))), rtol=1e-12)
        for rows, cols in (((1,), None), ((2, 0), (1,)), ((0, 1, 2), None)):
            _v, (rri, rci), rshape = jsparse.sptenmat(*_jsp(sp), rows, cols)
            _v, (ri, ci), shape = sptenmat(*_tsp(sp), rows, cols)
            assert shape == rshape
            np.testing.assert_array_equal(n(ri), n(rri))
            np.testing.assert_array_equal(n(ci), n(rci))


# ------------------------------------------------------------- constructors


class TestConstructors:
    def test_tenzeros_ones_diag(self):
        assert float(tenzeros((2, 3), device="cpu").sum()) == 0.0
        assert float(tenones((2, 3), device="cpu").sum()) == 6.0
        d = tendiag(torch.tensor([1.0, 2.0]), (2, 2, 2))
        assert float(d[0, 0, 0]) == 1.0 and float(d[1, 1, 1]) == 2.0
        assert float(torch.abs(d).sum()) == 3.0
        assert tenzeros((2, 3), device="cpu").dtype == torch.float32
        np.testing.assert_array_equal(n(tenzeros((2, 3), device="cpu")), n(jtu.tenzeros((2, 3))))
        np.testing.assert_array_equal(n(tenones((2, 3), device="cpu")), n(jtu.tenones((2, 3))))
        np.testing.assert_array_equal(n(d), n(jtu.tendiag(jnp.array([1.0, 2.0]), (2, 2, 2))))
        np.testing.assert_array_equal(
            n(tendiag(torch.tensor([1.0, 2.0]), (2, 3))), n(jtu.tendiag(jnp.array([1.0, 2.0]), (2, 3)))
        )

    def test_teneye_identity_property(self):
        # ttsv(E, x, -1) == x for unit x — the toolbox's own doc test
        # (teneye.m:12-16).
        e = teneye(4, 3, dtype=F64, device="cpu")
        x = rng(0).standard_normal(3)
        x = x / np.linalg.norm(x)
        np.testing.assert_allclose(n(ttsv(e, t(x), 1)), x, rtol=1e-12, atol=1e-13)
        with x64():
            ref = n(jtu.teneye(4, 3, jnp.float64))
        close(e, ref, rtol=RTOL_CLOSED)
        assert teneye(2, 3, device="cpu").dtype == torch.float32

    def test_teneye_odd_order_rejected(self):
        with pytest.raises(ValueError):
            teneye(3, 3, device="cpu")

    def test_tenrandblk(self):
        x = tenrandblk(_gen(), [(2, 3, 2), (3, 2, 4)], noise=0.01, device="cpu")
        assert tuple(x.shape) == (5, 5, 6)
        # block energy dominates the noise floor
        blk1 = x[:2, :3, :2]
        assert float(torch.linalg.vector_norm(blk1)) > 0.5
        # with no noise, each block has unit norm and the rest is zero
        clean = tenrandblk(_gen(1), [(2, 3, 2), (3, 2, 4)], noise=0.0, dtype=F64, device="cpu")
        np.testing.assert_allclose(float(torch.linalg.vector_norm(clean[:2, :3, :2])), 1.0, rtol=1e-12)
        np.testing.assert_allclose(float(torch.linalg.vector_norm(clean[2:, 3:, 2:])), 1.0, rtol=1e-12)
        np.testing.assert_allclose(float(torch.linalg.vector_norm(clean)) ** 2, 2.0, rtol=1e-12)
        ref = jtu.tenrandblk(jax.random.PRNGKey(0), [(2, 3, 2), (3, 2, 4)], noise=0.0)
        np.testing.assert_allclose(float(jnp.linalg.norm(ref.ravel())) ** 2, 2.0, rtol=1e-5)

    def test_matrand_family(self):
        q = matrandorth(_gen(), 5, device="cpu")
        np.testing.assert_allclose(n(q.T @ q), np.eye(5), atol=1e-5)
        a = rng(1).standard_normal((6, 3))
        m = matrandnorm(t(a))
        np.testing.assert_allclose(n(torch.linalg.vector_norm(m, dim=0)), np.ones(3), rtol=1e-12)
        with x64():
            close(m, n(jtu.matrandnorm(j(a))), rtol=RTOL_CLOSED)
        c = matrandcong(_gen(), 8, 3, gamma=0.6, device="cpu")
        g = n(c.T @ c)
        np.testing.assert_allclose(np.diag(g), np.ones(3), atol=1e-5)
        off = g[~np.eye(3, dtype=bool)]
        np.testing.assert_allclose(off, 0.6, atol=1e-5)
        with pytest.raises(ValueError):
            matrandcong(_gen(), 3, 3, gamma=0.5, device="cpu")
        # the draws cannot agree across packages; the contracts do
        jq = jtu.matrandorth(jax.random.PRNGKey(0), 5)
        np.testing.assert_allclose(n(jq.T @ jq), np.eye(5), atol=1e-5)
        jg = n(jtu.matrandcong(jax.random.PRNGKey(0), 8, 3, gamma=0.6))
        np.testing.assert_allclose((jg.T @ jg)[~np.eye(3, dtype=bool)], 0.6, atol=1e-5)
        with pytest.raises(ValueError):
            jtu.matrandcong(jax.random.PRNGKey(0), 3, 3, gamma=0.5)


# ------------------------------------------------------- ktensor / ttensor


class TestKruskalHelpers:
    def _rand_kt(self, seed=0, shape=(4, 5, 6), r=3):
        g = rng(seed)
        factors = [g.standard_normal((s, r)) for s in shape]
        weights = np.abs(g.standard_normal(r)) + 0.1
        return weights, factors

    def test_norm_matches_dense(self):
        w, fs = self._rand_kt()
        dense = np_ktensor_full(fs, w)
        got = float(ktensor_norm(t(w), tl(fs)))
        np.testing.assert_allclose(got, np.linalg.norm(dense), rtol=1e-12)
        with x64():
            ref = float(jtu.ktensor_norm(j(w), jl(fs)))
        np.testing.assert_allclose(got, ref, rtol=RTOL_CLOSED)

    def test_innerprod_dense_and_kt(self):
        w, fs = self._rand_kt()
        w2, fs2 = self._rand_kt(seed=7)
        d1, d2 = np_ktensor_full(fs, w), np_ktensor_full(fs2, w2)
        got_dense = float(ktensor_innerprod(t(w), tl(fs), t(d2)))
        got_kt = float(ktensor_innerprod(t(w), tl(fs), (t(w2), tl(fs2))))
        np.testing.assert_allclose(got_dense, np.sum(d1 * d2), rtol=1e-10)
        np.testing.assert_allclose(got_kt, np.sum(d1 * d2), rtol=1e-10)
        with x64():
            ref_dense = float(jtu.ktensor_innerprod(j(w), jl(fs), j(d2)))
            ref_kt = float(jtu.ktensor_innerprod(j(w), jl(fs), (j(w2), jl(fs2))))
        np.testing.assert_allclose(got_dense, ref_dense, rtol=RTOL_CLOSED)
        np.testing.assert_allclose(got_kt, ref_kt, rtol=RTOL_CLOSED)

    def test_arrange_and_fixsigns_invariant(self):
        w, fs = self._rand_kt()
        dense = np_ktensor_full(fs, w)
        wa, fa = ktensor_arrange(t(w), tl(fs))
        assert bool(torch.all(wa[:-1] >= wa[1:]))  # sorted descending
        close(ktensor_full(fa, wa), dense, rtol=1e-10)
        wf, ff = ktensor_fixsigns(t(w), tl(fs))
        close(ktensor_full(ff, wf), dense, rtol=1e-10)
        for u in ff:
            mx = torch.argmax(torch.abs(u), dim=0)
            assert bool(torch.all(u[mx, torch.arange(u.shape[1])] >= 0))
        # Gaussian columns have no ties in |u|, so the results are unique
        with x64():
            rwa, rfa = jtu.ktensor_arrange(j(w), jl(fs))
            rwf, rff = jtu.ktensor_fixsigns(j(w), jl(fs))
            rwa, rfa, rwf, rff = n(rwa), [n(u) for u in rfa], n(rwf), [n(u) for u in rff]
        close(wa, rwa, rtol=RTOL_CLOSED)
        close(wf, rwf, rtol=RTOL_CLOSED)
        for got, ref in zip(fa + ff, rfa + rff):
            close(got, ref, rtol=RTOL_CLOSED)

    def test_score_self_is_one(self):
        w, fs = self._rand_kt()
        s = ktensor_score(t(w), tl(fs), t(w), [u * 1.0 for u in tl(fs)])
        np.testing.assert_allclose(float(s), 1.0, atol=1e-12)
        # permuted components still score 1 (matching is permutation-free)
        perm = [2, 0, 1]
        s2 = ktensor_score(t(w), tl(fs), t(w[perm]), [t(u[:, perm]) for u in fs])
        np.testing.assert_allclose(float(s2), 1.0, atol=1e-12)
        # two different Kruskal tensors: the same greedy match as the reference
        w2, fs2 = self._rand_kt(seed=3)
        with x64():
            ref = float(jtu.ktensor_score(j(w), jl(fs), j(w2), jl(fs2)))
        np.testing.assert_allclose(
            float(ktensor_score(t(w), tl(fs), t(w2), tl(fs2))), ref, rtol=RTOL_CLOSED
        )
        assert 0.0 <= ref < 1.0

    def test_ttensor_full_and_norm(self):
        g = rng(0)
        core = g.standard_normal((2, 3, 2))
        factors = [g.standard_normal(sr) for sr in [(5, 2), (6, 3), (7, 2)]]
        dense = ttensor_full(t(core), tl(factors))
        close(dense, np.einsum("abc,ia,jb,kc->ijk", core, *factors), rtol=1e-12)
        got_norm = float(ttensor_norm(t(core), tl(factors)))
        np.testing.assert_allclose(got_norm, float(torch.linalg.vector_norm(dense)), rtol=1e-12)
        with x64():
            ref = n(jtu.ttensor_full(j(core), jl(factors)))
            ref_norm = float(jtu.ttensor_norm(j(core), jl(factors)))
        close(dense, ref, rtol=RTOL_CLOSED)
        np.testing.assert_allclose(got_norm, ref_norm, rtol=RTOL_CLOSED)

    def test_sumtensor(self):
        a = rng(0).standard_normal((3, 3))
        got = sumtensor_full([t(a), 2 * t(a)])
        np.testing.assert_allclose(n(got), 3 * a, rtol=1e-12)
        with x64():
            close(got, n(jtu.sumtensor_full([j(a), 2 * j(a)])), rtol=RTOL_CLOSED)


# ------------------------------------------------------------- CP variants


class TestCPVariants:
    def _lowrank_nonneg(self, seed=0, shape=(8, 9, 10), r=2):
        fs = random_factors(shape, r, seed, kind="uniform", offset=0.1)
        return np_ktensor_full(fs), fs

    def _rough(self, x, seed=40, level=0.05):
        """x with nonnegative noise, so that fits stay away from 1 and
        `n_iters` is the algorithm's, not rounding's."""
        return x + level * x.mean() * rng(seed).random(x.shape)

    def test_cp_nmu_recovers_fit(self):
        x, _ = self._lowrank_nonneg()
        init = random_factors(x.shape, 2, seed=1, kind="uniform")
        res = cp_nmu(t(x), rank=2, max_iters=500, tol=1e-9, init_factors=tl(init))
        assert float(res["fit"]) > 0.99
        for u in res["factors"]:
            assert bool(torch.all(u >= 0))
        xr = self._rough(x)
        with x64():
            ref = jcpv.cp_nmu(j(xr), 2, max_iters=500, tol=1e-5, init_factors=jl(init))
            ref_full = n(jkruskal.ktensor_full(ref["factors"], ref["weights"]))
            ref_fit, ref_iters = float(ref["fit"]), int(ref["n_iters"])
        got = cp_nmu(t(xr), 2, max_iters=500, tol=1e-5, init_factors=tl(init))
        assert got["n_iters"] == ref_iters and 1 < ref_iters < 500
        np.testing.assert_allclose(float(got["fit"]), ref_fit, rtol=RTOL_ITER)
        close(ktensor_full(got["factors"], got["weights"]), ref_full, rtol=RTOL_ITER)

    def test_cp_apr_poisson(self):
        x, _ = self._lowrank_nonneg()
        counts = rng(3).poisson(20.0 * x).astype(np.float64)
        init = random_factors(x.shape, 2, seed=1, kind="uniform")
        res = cp_apr(t(counts), rank=2, max_outer=30, init_factors=tl(init))
        m = ktensor_full(res["factors"], res["weights"])
        assert bool(torch.all(m >= 0))
        rel = float(torch.linalg.vector_norm(m - t(counts)) / np.linalg.norm(counts))
        assert rel < 0.35  # Poisson noise floor at mean ~20·x
        assert bool(torch.isfinite(res["log_likelihood"]))
        with x64():
            ref = jcpv.cp_apr(j(counts), 2, max_outer=30, init_factors=jl(init))
            ref_full = n(jkruskal.ktensor_full(ref["factors"], ref["weights"]))
            ref_ll, ref_kkt = float(ref["log_likelihood"]), float(ref["kkt_violation"])
            ref_iters = int(ref["n_iters"])
        assert res["n_iters"] == ref_iters
        close(m, ref_full, rtol=RTOL_ITER)
        np.testing.assert_allclose(float(res["log_likelihood"]), ref_ll, rtol=RTOL_ITER)
        np.testing.assert_allclose(float(res["kkt_violation"]), ref_kkt, rtol=1e-6, atol=1e-12)
        # the inner loop runs exactly max_inner sweeps: another count, another answer
        other = cp_apr(t(counts), rank=2, max_outer=2, max_inner=3, tol=0.0, init_factors=tl(init))
        with x64():
            ref_o = jcpv.cp_apr(j(counts), 2, max_outer=2, max_inner=3, tol=0.0, init_factors=jl(init))
            ref_o_full = n(jkruskal.ktensor_full(ref_o["factors"], ref_o["weights"]))
        assert other["n_iters"] == 2
        close(ktensor_full(other["factors"], other["weights"]), ref_o_full, rtol=RTOL_ITER)

    def test_cp_arls_matches_als_quality(self):
        x, _ = self._lowrank_nonneg()
        res = cp_arls(t(x), rank=2, n_samples=200, max_iters=60, tol=0.0, generator=_gen())
        assert float(res["fit"]) > 0.97
        assert res["n_iters"] == 60
        ref = jcpv.cp_arls(jnp.asarray(x, jnp.float32), 2, n_samples=200, max_iters=60, tol=0.0,
                           key=jax.random.PRNGKey(0))
        assert float(ref["fit"]) > 0.97  # the reference's own bar, on the same tensor
        # one mode solve on given indices, against numpy's normal equations
        g = rng(5)
        factors = random_factors(x.shape, 2, seed=6, kind="uniform")
        for mode in range(3):
            others = [ax for ax in range(3) if ax != mode]
            idx = [g.integers(0, x.shape[ax], 50) for ax in others]
            zs = factors[others[0]][idx[0]] * factors[others[1]][idx[1]]
            sel = [slice(None)] * 3
            xs = np.stack([
                x[tuple(i if ax == mode else idx[others.index(ax)][k] for ax, i in enumerate(sel))]
                for k in range(50)
            ], axis=1)
            gram = zs.T @ zs
            jitter = 32 * np.finfo(np.float64).eps * (np.trace(gram) / 2 + 1.0)
            want = np.linalg.solve(gram + jitter * np.eye(2), (xs @ zs).T).T
            got = cp_variants.arls_mode_solve(
                t(x), tl(factors), mode, [torch.from_numpy(i) for i in idx]
            )
            close(got, want, rtol=1e-9)

    def test_cp_opt(self):
        x, _ = self._lowrank_nonneg(shape=(6, 7, 8))
        res = cp_opt(t(x), rank=2, max_iters=300, generator=_gen())
        assert float(res["fit"]) > 0.99
        assert all(not u.requires_grad for u in res["factors"]) and not res["fit"].requires_grad
        # loss and gradient at a given point: autograd against jax.grad
        point = random_factors(x.shape, 2, seed=2)
        norm_sq = float(np.sum(x**2))
        with x64():
            jx = j(x)

            def ref_loss(fs):
                return jnp.sum((jx - jkruskal.ktensor_full(list(fs))) ** 2) / norm_sq

            ref_val, ref_grad = jax.value_and_grad(ref_loss)(tuple(jl(point)))
            ref_val, ref_grad = float(ref_val), [n(g) for g in ref_grad]
        params = [p.requires_grad_(True) for p in tl(point)]
        val = cp_variants.cp_objective(params, t(x), norm_sq)
        val.backward()
        np.testing.assert_allclose(float(val.detach()), ref_val, rtol=RTOL_CLOSED)
        for p, g in zip(params, ref_grad):
            close(p.grad, g, rtol=RTOL_CLOSED)

    def test_cp_wopt_ignores_masked_entries(self):
        x, _ = self._lowrank_nonneg(shape=(6, 7, 8))
        w = (rng(9).random(x.shape) > 0.3).astype(np.float64)
        # corrupt the unobserved entries wildly; the fit must not care
        x_corrupt = np.where(w > 0, x, 1e3)
        res = cp_wopt(t(x_corrupt), t(w), rank=2, max_iters=300, generator=_gen())
        m = n(ktensor_full(res["factors"], res["weights"]))
        rel = float(np.linalg.norm(w * (m - x)) / np.linalg.norm(w * x))
        assert rel < 0.05
        point = random_factors(x.shape, 2, seed=2)
        denom = float(np.sum((w * x_corrupt) ** 2))
        with x64():
            jw, jwx = j(w), j(w * x_corrupt)

            def ref_loss(fs):
                return jnp.sum((jwx - jw * jkruskal.ktensor_full(list(fs))) ** 2) / denom

            ref_val, ref_grad = jax.value_and_grad(ref_loss)(tuple(jl(point)))
            ref_val, ref_grad = float(ref_val), [n(g) for g in ref_grad]
        params = [p.requires_grad_(True) for p in tl(point)]
        val = cp_variants.cp_objective(params, t(w * x_corrupt), denom, t(w))
        val.backward()
        np.testing.assert_allclose(float(val.detach()), ref_val, rtol=RTOL_CLOSED)
        for p, g in zip(params, ref_grad):
            close(p.grad, g, rtol=RTOL_CLOSED)

    @pytest.mark.parametrize("loss", ["normal", "count", "bernoulli-logit"])
    def test_gcp_opt_losses(self, loss):
        x, _ = self._lowrank_nonneg(shape=(6, 7, 8))
        if loss == "bernoulli-logit":
            data = (x > np.median(x)).astype(np.float64)
        elif loss == "count":
            data = np.round(5.0 * x)
        else:
            data = x
        res = gcp_opt(t(data), rank=2, loss=loss, max_iters=400, generator=_gen())
        assert bool(torch.isfinite(res["objective"]))
        m = ktensor_full(res["factors"], res["weights"])
        assert bool(torch.all(torch.isfinite(m)))
        if loss == "normal":
            rel = float(torch.linalg.vector_norm(m - t(data)) / np.linalg.norm(data))
            assert rel < 0.15
        # step for step from one init: `objective` after k steps is the
        # value the k-th step started from, so k = 1..20 walks the first 20
        lower = cp_variants.GCP_LOSSES[loss][1]
        init = random_factors(x.shape, 2, seed=12, kind="uniform")
        if lower is None:
            init = [u - 0.5 for u in init]
        # a large rate, so that the projection of the bounded loss acts
        rate = 0.2
        for k in range(1, 21):
            with x64():
                ref = jcpv.gcp_opt(j(data), 2, loss=loss, max_iters=k, tol=0.0,
                                   learning_rate=rate, init_factors=jl(init))
                ref_obj, ref_iters = float(ref["objective"]), int(ref["n_iters"])
                ref_full = n(jkruskal.ktensor_full(ref["factors"], ref["weights"]))
            got = gcp_opt(t(data), 2, loss=loss, max_iters=k, tol=0.0, learning_rate=rate,
                          init_factors=tl(init))
            assert got["n_iters"] == ref_iters == k
            np.testing.assert_allclose(float(got["objective"]), ref_obj, rtol=RTOL_ITER)
        close(ktensor_full(got["factors"], got["weights"]), ref_full, rtol=RTOL_ITER)
        if lower is not None:
            assert min(float(u.min()) for u in got["factors"]) >= 0.0


# -------------------------------------------------------------- symmetric


def _sym(shape, seed=0):
    return np_symmetrize(rng(seed).standard_normal(shape))


class TestSymmetric:
    def test_symmetrize(self):
        x = rng(0).standard_normal((4, 4, 4))
        s = symmetrize(t(x))
        assert bool(is_symmetric(s))
        assert not bool(is_symmetric(t(x)))
        with x64():
            ref = n(jsym.symmetrize(j(x)))
            assert bool(jsym.is_symmetric(j(ref))) and not bool(jsym.is_symmetric(j(x)))
        close(s, ref, rtol=RTOL_CLOSED)

    def test_ttsv_orders(self):
        a = _sym((4, 4, 4))
        x = rng(1).standard_normal(4)
        np.testing.assert_allclose(
            float(ttsv(t(a), t(x), 0)), float(np.einsum("ijk,i,j,k->", a, x, x, x)), rtol=1e-12
        )
        close(ttsv(t(a), t(x), 1), np.einsum("ijk,j,k->i", a, x, x), rtol=1e-12)
        for keep in (0, 1, 2, 3):
            with x64():
                ref = n(jsym.ttsv(j(a), j(x), keep))
            close(ttsv(t(a), t(x), keep), ref, rtol=RTOL_CLOSED)

    def test_eig_sshopm_eigenpair(self):
        a = _sym((5, 5, 5, 5))
        x0 = rng(2).standard_normal(5)
        res = eig_sshopm(t(a), shift=2.0, max_iters=2000, tol=1e-13, x0=t(x0))
        lam, x = res["eigval"], res["eigvec"]
        # residual of the eigen equation Ax^{m-1} = λx
        r = ttsv(t(a), x, 1) - lam * x
        assert float(torch.linalg.vector_norm(r)) < 1e-4
        np.testing.assert_allclose(float(torch.linalg.vector_norm(x)), 1.0, rtol=1e-12)
        for concave, shift in ((False, 2.0), (True, -2.0)):
            with x64():
                ref = jsym.eig_sshopm(j(a), shift=shift, concave=concave, max_iters=2000,
                                      tol=1e-10, x0=j(x0))
                ref = (float(ref["eigval"]), n(ref["eigvec"]), int(ref["n_iters"]),
                       bool(ref["converged"]))
            got = eig_sshopm(t(a), shift=shift, concave=concave, max_iters=2000, tol=1e-10,
                             x0=t(x0))
            assert got["n_iters"] == ref[2] and bool(got["converged"]) == ref[3]
            np.testing.assert_allclose(float(got["eigval"]), ref[0], rtol=RTOL_ITER)
            close(got["eigvec"], ref[1], rtol=RTOL_ITER)
        # a random start from the generator, on the input's device and dtype
        rand = eig_sshopm(t(a), shift=2.0, max_iters=5, generator=_gen(3))
        assert rand["eigvec"].dtype == F64 and rand["n_iters"] == 5
        # no step: the normalized start comes back
        none = eig_sshopm(t(a), max_iters=0, x0=t(x0))
        close(none["eigvec"], x0 / np.linalg.norm(x0), rtol=1e-12)

    def test_eig_geap_reduces_to_sshopm_with_identity_b(self):
        a = _sym((4, 4, 4, 4))
        e = teneye(4, 4, dtype=F64, device="cpu")
        x0 = rng(4).standard_normal(4)
        res = eig_geap(t(a), e, shift=3.0, max_iters=3000, tol=1e-13, x0=t(x0))
        lam, x = res["eigval"], res["eigvec"]
        r = ttsv(t(a), x, 1) - lam * ttsv(e, x, 1)
        assert float(torch.linalg.vector_norm(r)) < 1e-3
        with x64():
            ref = jsym.eig_geap(j(a), j(n(e)), shift=3.0, max_iters=3000, tol=1e-10, x0=j(x0))
            ref = (float(ref["eigval"]), n(ref["eigvec"]), int(ref["n_iters"]))
        got = eig_geap(t(a), e, shift=3.0, max_iters=3000, tol=1e-10, x0=t(x0))
        assert got["n_iters"] == ref[2]
        np.testing.assert_allclose(float(got["eigval"]), ref[0], rtol=RTOL_ITER)
        close(got["eigvec"], ref[1], rtol=RTOL_ITER)

    def test_cp_sym(self):
        g = rng(5)
        u = g.standard_normal((6, 2))
        w = np.array([2.0, -1.0])
        x = symktensor_full(t(w), t(u), 3)
        with x64():
            close(x, n(jsym.symktensor_full(j(w), j(u), 3)), rtol=RTOL_CLOSED)
        res = cp_sym(x, rank=2, max_iters=2000, generator=_gen(2))
        assert float(res["fit"]) > 0.95
        assert not res["u"].requires_grad and not res["weights"].requires_grad
        # step for step: the reference draws (u0, w0) from its key; the same
        # two draws are repeated here and handed to the port
        key = jax.random.PRNGKey(2)
        xn = n(x)
        with x64():
            ku, kw = jax.random.split(key)
            u0 = n(jax.random.normal(ku, (6, 2), jnp.float64) * (1.0 / jnp.sqrt(6)))
            w0 = n(jax.random.normal(kw, (2,), jnp.float64))
        for k in range(1, 21):
            with x64():
                ref = jsym.cp_sym(j(xn), 2, max_iters=k, tol=0.0, key=key)
                ref_fit, ref_iters = float(ref["fit"]), int(ref["n_iters"])
                ref_full = n(jsym.symktensor_full(ref["weights"], ref["u"], 3))
            got = cp_sym(x, 2, max_iters=k, tol=0.0, init=(t(w0), t(u0)))
            assert got["n_iters"] == ref_iters == k
            # fit = 1 - sqrt(loss): the loss to 1e-8
            np.testing.assert_allclose(
                (1.0 - float(got["fit"])) ** 2, (1.0 - ref_fit) ** 2, rtol=RTOL_ITER
            )
        close(symktensor_full(got["weights"], got["u"], 3), ref_full, rtol=RTOL_ITER)

    def test_tucker_sym(self):
        # symmetric low-multilinear-rank tensor
        g = rng(6)
        u = np.linalg.qr(g.standard_normal((7, 3)))[0]
        core = np_symmetrize(g.standard_normal((3, 3, 3)))
        x = tucker_ttm(t(core), tl([u, u, u]), transpose=False)
        res = tucker_sym(x, rank=3)
        assert float(res["fit"]) > 0.999
        # factor is orthonormal
        np.testing.assert_allclose(n(res["u"].T @ res["u"]), np.eye(3), atol=1e-10)
        close(projector(res["u"]), projector(u), rtol=1e-8)
        # parity where the fit is not 1: symmetric noise on top
        xn = n(x) + 0.05 * _sym((7, 7, 7), seed=7)
        with x64():
            ref = jsym.tucker_sym(j(xn), 3, tol=1e-9)
            ref_recon = n(jdecomp.tucker_ttm(ref["core"], [ref["u"]] * 3))
            ref = (float(ref["fit"]), int(ref["n_iters"]), projector(ref["u"]))
        got = tucker_sym(t(xn), 3, tol=1e-9)
        assert got["n_iters"] == ref[1] and 1 < ref[1] < 100
        np.testing.assert_allclose(float(got["fit"]), ref[0], rtol=RTOL_ITER)
        close(projector(got["u"]), ref[2], rtol=RTOL_ITER)
        close(tucker_ttm(got["core"], [got["u"]] * 3), ref_recon, rtol=RTOL_ITER)


# -------------------------------------------------------------- problem/io


class TestProblemAndIO:
    def test_create_problem_binary(self):
        res = create_problem_binary(_gen(), (6, 7, 8), rank=2, device="cpu")
        assert set(np.unique(n(res["data"]))) <= {0.0, 1.0}
        assert bool(torch.all((res["prob"] >= 0) & (res["prob"] <= 1)))
        ref = jtu.create_problem_binary(jax.random.PRNGKey(0), (6, 7, 8), rank=2)
        assert set(res) == set(ref)
        assert res["data"].dtype == torch.float32 and tuple(res["data"].shape) == (6, 7, 8)
        # prob is the odds tensor of the factors, mixed with the noise level
        m = np_ktensor_full([n(u).astype(np.float64) for u in res["factors"]])
        np.testing.assert_allclose(n(res["prob"]), 0.9 * m / (1 + m) + 0.05, rtol=1e-5)

    def test_export_import_roundtrip(self, tmp_path):
        x = rng(0).standard_normal((3, 4, 2))
        p = str(tmp_path / "t.ttx")
        export_data(t(x), p)
        back = import_data(p)
        np.testing.assert_allclose(back, x, rtol=1e-12)
        # a file written by either package is read by the other
        np.testing.assert_array_equal(jtu.import_data(p), back)
        q = str(tmp_path / "j.ttx")
        with x64():
            jtu.export_data(j(x[:, :, 0]), q)
        np.testing.assert_array_equal(import_data(q), jtu.import_data(q))
        with open(p) as f, open(str(tmp_path / "jt.ttx"), "w+") as h:
            with x64():
                jtu.export_data(j(x), h.name)
            assert f.read() == h.read()

    def test_khatrirao_reverse(self):
        g = rng(0)
        a, b = g.standard_normal((3, 2)), g.standard_normal((4, 2))
        np.testing.assert_allclose(
            n(khatrirao(t(a), t(b), reverse=True)), n(khatrirao(t(b), t(a))), rtol=1e-12
        )


class TestModeProducts:
    """Single-mode ttm/ttv — `@tensor/ttm.m`, `@tensor/ttv.m` semantics."""

    def test_ttm_matches_unfold_identity(self):
        g = rng(0)
        x, u, w = g.standard_normal((4, 5, 6)), g.standard_normal((3, 5)), g.standard_normal((4, 3))
        got = ttm(t(x), t(u), 1)
        close(got, np.einsum("ijt,kj->ikt", x, u), rtol=1e-12)
        # 't' flag: contracts U^T, so U is (n_mode, k) here
        got_t = ttm(t(x), t(w), 0, transpose=True)
        assert tuple(got_t.shape) == (3, 5, 6)
        close(got_t, np.einsum("ijt,ik->kjt", x, w), rtol=1e-12)
        with x64():
            ref, ref_t = n(jtu.ttm(j(x), j(u), 1)), n(jtu.ttm(j(x), j(w), 0, transpose=True))
        close(got, ref, rtol=RTOL_CLOSED)
        close(got_t, ref_t, rtol=RTOL_CLOSED)

    def test_ttm_composes_to_tucker_ttm(self):
        g = rng(1)
        x = g.standard_normal((4, 5, 6))
        us = [g.standard_normal((3, s)) for s in x.shape]
        seq = t(x)
        for ax, u in enumerate(us):
            seq = ttm(seq, t(u), ax)
        close(seq, tucker_ttm(t(x), tl(us)), rtol=1e-12)
        with x64():
            close(seq, n(jdecomp.tucker_ttm(j(x), jl(us))), rtol=RTOL_CLOSED)

    def test_ttv_single_and_multi(self):
        g = rng(2)
        x = g.standard_normal((4, 5, 6))
        v = g.standard_normal(5)
        got = ttv(t(x), t(v), 1)
        close(got, np.einsum("ijt,j->it", x, v), rtol=1e-12)
        vs = [g.standard_normal(s) for s in x.shape]
        full = ttv(t(x), tl(vs))  # all modes -> scalar
        np.testing.assert_allclose(float(full), float(np.einsum("ijt,i,j,t->", x, *vs)), rtol=1e-12)
        # out-of-order modes
        part = ttv(t(x), [t(vs[2]), t(vs[0])], modes=[2, 0])
        close(part, np.einsum("ijt,t,i->j", x, vs[2], vs[0]), rtol=1e-12)
        with x64():
            ref = n(jtu.ttv(j(x), j(v), 1))
            ref_full = float(jtu.ttv(j(x), jl(vs)))
            ref_part = n(jtu.ttv(j(x), [j(vs[2]), j(vs[0])], modes=[2, 0]))
        close(got, ref, rtol=RTOL_CLOSED)
        np.testing.assert_allclose(float(full), ref_full, rtol=RTOL_CLOSED)
        close(part, ref_part, rtol=RTOL_CLOSED)


class TestSshopmc:
    """eig_sshopmc — complex shifted power method (`eig_sshopmc.m:93-103`)."""

    def _sym4(self, size=4, seed=0):
        return _sym((size,) * 4, seed)

    def test_real_eigenpair_matches_sshopm(self):
        a = t(self._sym4(), torch.float32)
        real = eig_sshopm(a, shift=6.0, max_iters=2000, tol=1e-10)
        # start at the real solution: sshopmc must stay there
        out = eig_sshopmc(a, shift=6.0, max_iters=2000, tol=1e-10,
                          x0=real["eigvec"].to(torch.complex64))
        assert bool(out["converged"])
        assert out["eigval"].dtype == torch.complex64
        np.testing.assert_allclose(float(out["eigval"].real), float(real["eigval"]), rtol=1e-4)
        assert abs(float(out["eigval"].imag)) < 1e-4

    def test_residual_is_eigenpair(self):
        a = self._sym4(seed=3)
        g = rng(8)
        x0 = (2.0 * g.random(4) - 1.0) + 1j * g.standard_normal(4)
        out = eig_sshopmc(t(a), shift=4.0, max_iters=5000, tol=1e-12, x0=torch.from_numpy(x0))
        x, lam = out["eigvec"], out["eigval"]
        assert x.dtype == torch.complex128
        resid = ttsv(t(a).to(x.dtype), x, 1) - lam * x
        assert float(torch.linalg.vector_norm(resid)) < 5e-3
        with x64():
            ref = jsym.eig_sshopmc(j(a), shift=4.0, max_iters=5000, tol=1e-10, x0=j(x0))
            ref = (complex(ref["eigval"]), n(ref["eigvec"]), int(ref["n_iters"]))
        got = eig_sshopmc(t(a), shift=4.0, max_iters=5000, tol=1e-10, x0=torch.from_numpy(x0))
        assert got["n_iters"] == ref[2]
        np.testing.assert_allclose(complex(got["eigval"]), ref[0], rtol=RTOL_ITER)
        close(got["eigvec"], ref[1], rtol=RTOL_ITER)
        # a zero iterate surfaces as a NaN eigenpair, not as an exception
        zero = eig_sshopmc(torch.zeros((3, 3, 3), dtype=F64), shift=0.0, max_iters=3,
                           x0=torch.ones(3, dtype=torch.complex128))
        assert bool(torch.isnan(zero["eigvec"].real).all())
        # the random start is complex and comes from the generator
        rand = eig_sshopmc(t(a), shift=4.0, max_iters=3, generator=_gen(1))
        assert rand["eigvec"].dtype == torch.complex128 and rand["n_iters"] == 3


# ------------------------------------------- the rest of the 68 names


class TestRemainingSurface:
    """Names of the flat namespace that `tests/test_tensor_toolbox.py` does
    not reach: each against its JAX counterpart."""

    def test_ttt_outer_partial_and_inner(self):
        g = rng(0)
        a, b = g.standard_normal((3, 4, 5)), g.standard_normal((4, 3, 6))
        for kw in ({}, {"adims": 0, "bdims": 1}, {"adims": (0, 1), "bdims": (1, 0)}):
            with x64():
                ref = n(jtu.ttt(j(a), j(b), **kw))
            close(tenutils.ttt(t(a), t(b), **kw), ref, rtol=RTOL_CLOSED)
        with x64():
            ref = float(jtu.ttt(j(a), j(a), adims=(0, 1, 2)))
        np.testing.assert_allclose(float(tenutils.ttt(t(a), t(a), adims=(0, 1, 2))), ref, rtol=RTOL_CLOSED)

    def test_nvecs_projector_and_signs(self):
        x = rng(1).standard_normal((6, 5, 4))
        for mode in range(3):
            with x64():
                ref = n(jtu.nvecs(j(x), mode, 2))
                ref_raw = n(jtu.nvecs(j(x), mode, 2, flipsign=False))
            got = tenutils.nvecs(t(x), mode, 2)
            # with the sign fixed and no ties, the columns themselves agree
            close(got, ref, rtol=RTOL_ITER)
            peak = np.abs(n(got)).argmax(axis=0)
            assert (n(got)[peak, np.arange(2)] > 0).all()
            close(projector(tenutils.nvecs(t(x), mode, 2, flipsign=False)), projector(ref_raw),
                  rtol=RTOL_ITER)

    def test_collapse_contract_scale(self):
        g = rng(2)
        x = g.standard_normal((3, 4, 3))
        for dims, fun, jfun in ((None, torch.sum, jnp.sum), (1, torch.sum, jnp.sum),
                                ((0, 2), torch.amax, jnp.max), (-1, torch.mean, jnp.mean),
                                ((-0 - 2,), torch.sum, jnp.sum), ((), torch.sum, jnp.sum)):
            with x64():
                ref = n(jtu.collapse(j(x), dims, jfun))
            close(tenutils.collapse(t(x), dims, fun), ref, rtol=RTOL_CLOSED)
        with pytest.raises(ValueError):
            tenutils.collapse(t(x), (1, -2))
        with x64():
            ref = n(jtu.contract(j(x), 0, 2))
        close(tenutils.contract(t(x), 0, 2), ref, rtol=RTOL_CLOSED)
        with pytest.raises(ValueError):
            tenutils.contract(t(x), 0, 1)
        with pytest.raises(ValueError):
            tenutils.contract(t(x), 1, 1)
        s1, s2 = g.standard_normal(4), g.standard_normal((3, 3))
        with x64():
            ref1 = n(jtu.scale(j(x), j(s1), 1))
            ref2 = n(jtu.scale(j(x), j(s2), (2, 0)))
        close(tenutils.scale(t(x), t(s1), 1), ref1, rtol=RTOL_CLOSED)
        close(tenutils.scale(t(x), t(s2), (2, 0)), ref2, rtol=RTOL_CLOSED)
        with pytest.raises(ValueError):
            tenutils.scale(t(x), t(s1), 0)

    def test_create_guess_and_sp_elemwise(self):
        fs = tenutils.create_guess(_gen(), (4, 5, 6), 3, device="cpu")
        ref = jtu.create_guess(jax.random.PRNGKey(0), (4, 5, 6), 3)
        assert [tuple(u.shape) for u in fs] == [tuple(u.shape) for u in ref]
        assert all(0.0 <= float(u.min()) and float(u.max()) < 1.0 for u in fs)
        assert all(u.dtype == torch.float32 for u in fs)
        sp = _sp((4, 5, 6), 12, seed=3)
        vals, coords, shape = sparse.sp_elemwise(*_tsp(sp), lambda v: v**2)
        rv, _rc, rshape = jsparse.sp_elemwise(*_jsp(sp), lambda v: v**2)
        close(vals, n(rv), rtol=1e-6)
        assert shape == rshape and coords.dtype == torch.int64

    def test_cp_als_sparse_matches_reference_and_dense(self):
        from tritd_tpu_torch.ops import cp_als, cp_als_sparse

        shape, rank = (8, 7, 6), 2
        dense_lr = np_ktensor_full(random_factors(shape, rank, seed=4, kind="uniform"))
        g = rng(5)
        keep = g.random(shape) < 0.6
        coords = np.argwhere(keep)
        vals = dense_lr[keep]
        # one duplicate coordinate: both must add it up before taking norms
        coords = np.concatenate([coords, coords[:1]])
        vals = np.concatenate([vals, [0.25]])
        sp = (vals, coords, shape)
        init = random_factors(shape, rank, seed=6, kind="uniform")
        with x64():
            ref = jsparse.cp_als_sparse(*_jsp(sp), rank, max_iters=40, tol=1e-7, init_factors=jl(init))
            ref_full = n(jkruskal.ktensor_full(ref["factors"], ref["weights"]))
            ref_fit, ref_iters = float(ref["fit"]), int(ref["n_iters"])
        got = cp_als_sparse(*_tsp(sp), rank, max_iters=40, tol=1e-7, init_factors=tl(init))
        assert got["n_iters"] == ref_iters and 1 < ref_iters
        np.testing.assert_allclose(float(got["fit"]), ref_fit, rtol=RTOL_ITER)
        close(ktensor_full(got["factors"], got["weights"]), ref_full, rtol=RTOL_ITER)
        # the sparse path is the dense one on the zero-filled tensor
        dense = cp_als(sp_full(*_tsp(sp)), rank, max_iters=40, tol=1e-7, init_factors=tl(init))
        assert dense["n_iters"] == got["n_iters"]
        np.testing.assert_allclose(float(dense["fit"]), float(got["fit"]), rtol=RTOL_ITER)
        none = cp_als_sparse(*_tsp(sp), rank, max_iters=0, init_factors=tl(init))
        assert none["n_iters"] == 0 and float(none["fit"]) == -np.inf

    def test_out_of_range_coordinate_raises_on_the_cpu(self):
        """The reference clamps or drops such an index; the port raises on the
        CPU, and validates on the host before anything reaches a device."""
        vals = np.array([1.0, 2.0])
        coords = np.array([[0, 0, 0], [1, 2, 5]])
        with pytest.raises(IndexError):
            interop.sptensor_from_numpy(vals, coords, (2, 3, 5))
        with pytest.raises(IndexError):
            interop.sptensor_from_numpy(vals, -coords, (2, 3, 5))
        with pytest.raises(ValueError):
            interop.sptensor_from_numpy(vals, coords[:, :2], (2, 3, 5))
        with pytest.raises((IndexError, RuntimeError)):
            sp_full(t(vals), torch.from_numpy(coords), (2, 3, 5))
        with pytest.raises((IndexError, RuntimeError)):
            sp_mttkrp(t(vals), torch.from_numpy(coords), (2, 3, 5),
                      tl(random_factors((2, 3, 5), 2)), 0)

    @pytest.mark.parametrize("name", sorted(cp_variants.GCP_LOSSES))
    def test_gcp_losses_table(self, name):
        assert sorted(cp_variants.GCP_LOSSES) == sorted(jcpv.GCP_LOSSES)
        fn, lower = cp_variants.GCP_LOSSES[name]
        jfn, jlower = jcpv.GCP_LOSSES[name]
        assert lower == jlower
        g = rng(7)
        x = np.round(3 * g.random((4, 5)))
        m = g.standard_normal((4, 5)) if lower is None else g.random((4, 5)) + 0.05
        m[0, 0] = 0.0 if lower is not None else m[0, 0]  # the 1e-10 guard
        with x64():
            ref = n(jfn(j(x), j(m)))
        close(fn(t(x), t(m)), ref, rtol=RTOL_CLOSED)
        with pytest.raises(ValueError):
            gcp_opt(t(x), 2, loss="no-such-loss")

    def test_interop_round_trips(self):
        g = rng(8)
        w, fs = g.random(3), [g.standard_normal((s, 3)) for s in (4, 5)]
        tw, tfs = interop.ktensor_from_numpy(w, fs, dtype=F64, device="cpu")
        bw, bfs = interop.ktensor_to_numpy(tw, tfs)
        np.testing.assert_array_equal(bw, w)
        assert all((a == b).all() for a, b in zip(bfs, fs))
        assert interop.ktensor_from_numpy(None, fs, device="cpu")[0] is None
        assert interop.ktensor_from_numpy(w, fs, device="cpu")[1][0].dtype == torch.float32
        core = g.standard_normal((3, 3))
        tc, tfs = interop.ttensor_from_numpy(core, fs, dtype=F64, device="cpu")
        bc, bfs = interop.ttensor_to_numpy(tc, tfs)
        np.testing.assert_array_equal(bc, core)
        # JAX arrays go in as they are, int32 coordinates come out int64
        vals, coords, shape = _jsp(_sp((4, 5, 6), 9, seed=9))
        tv, tcoords, tshape = interop.sptensor_from_numpy(vals, coords, shape, device="cpu")
        assert tcoords.dtype == torch.int64 and tshape == (4, 5, 6)
        bv, bcoords, bshape = interop.sptensor_to_numpy(tv, tcoords, tshape)
        np.testing.assert_array_equal(bcoords, n(coords))
        np.testing.assert_allclose(bv, n(vals), rtol=1e-6)
