"""PyTorch port, Tensor Toolbox surface I: `ops/kruskal.py` and
`ops/decomp.py` held against `tritd_tpu/ops/{kruskal,decomp}.py`.

Each test is the twin of one in `tests/test_decomp.py` or of one of the
first six of `tests/test_kruskal_trpca.py`: it keeps that test's own
assertion, made on the port, and adds parity — the same numpy float64
inputs through the JAX function (under `jax.enable_x64`) and the torch one.

Tolerances: rtol 1e-10 for closed-form functions (only the summation order
differs: XLA's einsum path against the port's written-out GEMM chain);
1e-8 for the iterative ones, which run from an injected init and must
return the reference's `n_iters`. Bases (HOSVD/HOOI factors,
`_leading_basis`) are unique only up to sign: they are compared through
their projectors U Uᵀ and through the reconstructed tensor."""

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
    one_torch_thread,
    projector,
    random_factors,
    rng,
    t,
    tl,
    x64,
)
from tritd_tpu.ops import decomp as jdecomp  # noqa: E402
from tritd_tpu.ops import kruskal as jkruskal  # noqa: E402
from tritd_tpu.ops import tenutils as jtenutils  # noqa: E402
from tritd_tpu_torch.ops import decomp, kruskal, tenutils  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _random_cp(shape, rank, seed=7):
    factors = random_factors(shape, rank, seed)
    return factors, np_ktensor_full(factors)


def _rre(x_hat, x):
    return float(np.linalg.norm(n(x_hat) - x) / np.linalg.norm(x))


def _cp_als_both(x, rank, init, **kw):
    """cp_als from one injected init through both packages."""
    with x64():
        ref = jdecomp.cp_als(j(x), rank, init_factors=jl(init), **kw)
        ref_full = n(jkruskal.ktensor_full(ref["factors"], ref["weights"]))
        ref = {"fit": float(ref["fit"]), "n_iters": int(ref["n_iters"]), "full": ref_full}
    res = decomp.cp_als(t(x), rank, init_factors=tl(init), **kw)
    return res, ref


def _noisy(clean, seed=21, level=0.01):
    """On an exact low-rank tensor the fit is 1 - sqrt(rounding): its
    changes from sweep to sweep are rounding noise of 1e-8, above any
    `tol`, and `n_iters` is then not defined across packages. Parity of
    `n_iters` is held on the same tensor with 1% noise, where the fit's
    changes are the algorithm's."""
    nz = rng(seed).standard_normal(clean.shape)
    return clean + level * np.linalg.norm(clean) / np.linalg.norm(nz) * nz


def _assert_cp_parity(res, ref, rtol=RTOL_ITER):
    assert res["n_iters"] == ref["n_iters"]
    np.testing.assert_allclose(float(res["fit"]), ref["fit"], rtol=rtol, atol=rtol)
    close(kruskal.ktensor_full(res["factors"], res["weights"]), ref["full"], rtol=rtol)


# --- twins of tests/test_decomp.py ------------------------------------------


def test_mttkrp_matches_tenmat_khatrirao():
    shape, rank = (5, 4, 6, 3), 3
    factors, _ = _random_cp(shape, rank)
    x = rng(1).standard_normal(shape)
    for mode in range(len(shape)):
        others = [t(factors[ax]) for ax in range(len(shape)) if ax != mode]
        want = kruskal.tenmat(t(x), (mode,)) @ kruskal.khatrirao(*others)
        got = decomp.mttkrp(t(x), tl(factors), mode)
        close(got, want, rtol=1e-12)
        with x64():
            ref = n(jdecomp.mttkrp(j(x), jl(factors), mode))
        close(got, ref, rtol=RTOL_CLOSED)


def test_cp_als_recovers_low_rank():
    shape, rank = (12, 10, 8), 3
    _, clean = _random_cp(shape, rank)
    init = random_factors(shape, rank, seed=2, kind="uniform")
    res = decomp.cp_als(t(clean), rank, max_iters=200, tol=1e-9, init_factors=tl(init))
    assert _rre(kruskal.ktensor_full(res["factors"], res["weights"]), clean) < 1e-3
    assert float(res["fit"]) > 0.999
    _assert_cp_parity(*_cp_als_both(_noisy(clean), rank, init, max_iters=200, tol=1e-9))


def test_cp_als_fit_matches_reconstruction():
    shape, rank = (9, 7, 5), 2
    x = rng(7).standard_normal(shape)
    init = random_factors(shape, rank, seed=0, kind="uniform")
    res, ref = _cp_als_both(x, rank, init, max_iters=30, tol=0.0)
    rel = _rre(kruskal.ktensor_full(res["factors"], res["weights"]), x)
    np.testing.assert_allclose(float(res["fit"]), 1.0 - rel, atol=1e-4)
    assert res["n_iters"] == 30
    _assert_cp_parity(res, ref)


def test_cp_als_4way():
    shape, rank = (6, 5, 4, 3), 2
    _, clean = _random_cp(shape, rank)
    init = random_factors(shape, rank, seed=3, kind="uniform")
    res = decomp.cp_als(t(clean), rank, max_iters=300, tol=1e-10, init_factors=tl(init))
    assert float(res["fit"]) > 0.99
    _assert_cp_parity(*_cp_als_both(_noisy(clean), rank, init, max_iters=300, tol=1e-10))


def test_tucker_ttm_transpose_roundtrip():
    shape, ranks = (8, 7, 6), (3, 3, 3)
    x = rng(7).standard_normal(shape)
    hs = decomp.tucker_hosvd(t(x), ranks)
    for u in hs["factors"]:
        np.testing.assert_allclose(n(u.T @ u), np.eye(u.shape[1]), atol=1e-12)
    recon = decomp.tucker_ttm(hs["core"], hs["factors"])
    assert tuple(recon.shape) == shape
    with x64():
        ref = jdecomp.tucker_hosvd(j(x), ranks)
        ref_recon = n(jdecomp.tucker_ttm(ref["core"], ref["factors"]))
        ref_proj = [projector(u) for u in ref["factors"]]
    # a Gaussian tensor's spectrum has no ties: the projectors are unique
    close(recon, ref_recon, rtol=RTOL_ITER)
    for u, p in zip(hs["factors"], ref_proj):
        close(projector(u), p, rtol=RTOL_ITER)


def test_hosvd_exact_on_exact_tucker_rank():
    ranks, dims = (2, 3, 2), (9, 8, 7)
    g = rng(7)
    core = g.standard_normal(ranks)
    us = [np.linalg.qr(g.standard_normal((d, r)))[0] for d, r in zip(dims, ranks)]
    x = decomp.tucker_ttm(t(core), tl(us))
    with x64():
        ref_x = n(jdecomp.tucker_ttm(j(core), jl(us)))
    close(x, ref_x, rtol=RTOL_CLOSED)
    hs = decomp.tucker_hosvd(x, ranks)
    recon = decomp.tucker_ttm(hs["core"], hs["factors"])
    np.testing.assert_allclose(n(recon), n(x), atol=1e-10)
    # the alias of the flat namespace is the same function
    from tritd_tpu_torch import ops

    assert ops.hosvd is decomp.tucker_hosvd and ops.tucker_als is decomp.tucker_hooi


def test_hooi_improves_or_matches_hosvd():
    shape, ranks = (10, 9, 8), (3, 3, 3)
    x = rng(7).standard_normal(shape)
    tx = t(x)
    hs = decomp.tucker_hosvd(tx, ranks)
    hs_err = float(torch.linalg.vector_norm(tx - decomp.tucker_ttm(hs["core"], hs["factors"])))
    res = decomp.tucker_hooi(tx, ranks, max_iters=50, tol=1e-10)
    hooi_recon = decomp.tucker_ttm(res["core"], res["factors"])
    hooi_err = float(torch.linalg.vector_norm(tx - hooi_recon))
    assert hooi_err <= hs_err * (1 + 1e-5)
    rel = hooi_err / float(np.linalg.norm(x))
    np.testing.assert_allclose(float(res["fit"]), 1.0 - rel, atol=1e-8)
    with x64():
        ref = jdecomp.tucker_hooi(j(x), ranks, max_iters=50, tol=1e-10)
        ref_recon = n(jdecomp.tucker_ttm(ref["core"], ref["factors"]))
        ref_fit, ref_iters = float(ref["fit"]), int(ref["n_iters"])
        ref_proj = [projector(u) for u in ref["factors"]]
    assert res["n_iters"] == ref_iters
    np.testing.assert_allclose(float(res["fit"]), ref_fit, rtol=RTOL_ITER)
    close(hooi_recon, ref_recon, rtol=RTOL_ITER)
    for u, p in zip(res["factors"], ref_proj):
        close(projector(u), p, rtol=RTOL_ITER)


def test_cp_als_nvecs_init_deterministic_recovery():
    shape, rank = (20, 15, 30), 3
    _, clean = _random_cp(shape, rank)
    # nvecs init recovers regardless of the seed (no random numbers enter:
    # rank <= every dimension)
    for seed in (0, 3, 4):
        res = decomp.cp_als(t(clean), rank, max_iters=100, tol=1e-12,
                            generator=torch.Generator().manual_seed(seed), init="nvecs")
        assert float(res["fit"]) > 0.9999
    # parity at a fixed number of sweeps; the init's column signs are free,
    # the fitted tensor is not
    with x64():
        ref = jdecomp.cp_als(j(clean), rank, max_iters=25, tol=0.0, init="nvecs")
        ref_fit = float(ref["fit"])
        ref_full = n(jkruskal.ktensor_full(ref["factors"], ref["weights"]))
    res = decomp.cp_als(t(clean), rank, max_iters=25, tol=0.0, init="nvecs")
    assert res["n_iters"] == 25
    np.testing.assert_allclose(float(res["fit"]), ref_fit, atol=RTOL_ITER)
    close(kruskal.ktensor_full(res["factors"], res["weights"]), ref_full, rtol=RTOL_ITER)


def test_cp_als_overcomplete_rank_stays_finite():
    shape = (8, 7, 6)
    _, clean = _random_cp(shape, 2)
    res = decomp.cp_als(t(clean), 12, max_iters=10, init="nvecs")  # rank > every dim
    assert bool(torch.isfinite(res["fit"]))
    assert all(bool(torch.isfinite(u).all()) for u in res["factors"])
    # float32 too: the jitter scales with the dtype's own eps
    res32 = decomp.cp_als(t(clean, torch.float32), 12, max_iters=10, init="nvecs")
    assert bool(torch.isfinite(res32["fit"]))
    # and the reference stays finite on the same input
    ref = jdecomp.cp_als(jnp.asarray(clean, jnp.float32), 12, max_iters=10, init="nvecs")
    assert bool(jnp.isfinite(ref["fit"]))


def test_cp_als_bad_init_raises():
    x = t(rng(7).standard_normal((4, 4, 4)))
    with pytest.raises(ValueError, match="init"):
        decomp.cp_als(x, 2, init="bogus")


@pytest.mark.parametrize("rank", [1, 4])
def test_cp_als_rank_edges(rank):
    shape = (6, 5, 4)
    _, clean = _random_cp(shape, rank, seed=70 + rank)
    init = random_factors(shape, rank, seed=9, kind="uniform")
    res = decomp.cp_als(t(clean), rank, max_iters=400, tol=1e-11, init_factors=tl(init))
    assert float(res["fit"]) > 0.98
    _assert_cp_parity(*_cp_als_both(_noisy(clean), rank, init, max_iters=400, tol=1e-9))


# --- twins of the first six of tests/test_kruskal_trpca.py -------------------


def test_khatrirao_matches_definition():
    g = rng(0)
    a, b = g.standard_normal((3, 4)), g.standard_normal((5, 4))
    kr = kruskal.khatrirao(t(a), t(b))
    assert tuple(kr.shape) == (15, 4)
    for i in range(3):
        for k in range(5):
            np.testing.assert_allclose(n(kr[i * 5 + k]), a[i] * b[k], rtol=1e-12)
    with x64():
        ref = n(jkruskal.khatrirao(j(a), j(b)))
        ref_rev = n(jkruskal.khatrirao(j(a), j(b), reverse=True))
    close(kr, ref, rtol=RTOL_CLOSED)
    close(kruskal.khatrirao(t(a), t(b), reverse=True), ref_rev, rtol=RTOL_CLOSED)


def test_ktensor_full_vs_einsum():
    us = random_factors((3, 4, 5), 2, seed=0)
    w = np.array([2.0, -1.0])
    got = kruskal.ktensor_full(tl(us), t(w))
    close(got, np.einsum("ir,jr,tr,r->ijt", *us, w), rtol=1e-12)
    with x64():
        ref = n(jkruskal.ktensor_full(jl(us), j(w)))
        ref_unit = n(jkruskal.ktensor_full(jl(us)))
    close(got, ref, rtol=RTOL_CLOSED)
    close(kruskal.ktensor_full(tl(us)), ref_unit, rtol=RTOL_CLOSED)


def test_tenmat_roundtrip_entries():
    x = rng(0).standard_normal((3, 4, 5))
    m = kruskal.tenmat(t(x), (1,))
    assert tuple(m.shape) == (4, 15)
    np.testing.assert_array_equal(n(m[2]), x[:, 2, :].ravel())
    with x64():
        ref = n(jkruskal.tenmat(j(x), (1,)))
        ref2 = n(jkruskal.tenmat(j(x), (2, 0), (1,)))
    np.testing.assert_array_equal(n(m), ref)
    np.testing.assert_array_equal(n(kruskal.tenmat(t(x), (2, 0), (1,))), ref2)


def test_cp_normalize():
    us = random_factors((3, 4, 5), 2, seed=0)
    nfs, w = kruskal.cp_normalize(tl(us))
    for u in nfs:
        np.testing.assert_allclose(n(torch.linalg.vector_norm(u, dim=0)), np.ones(2), rtol=1e-12)
    close(kruskal.ktensor_full(nfs, w), np_ktensor_full(us), rtol=1e-12)
    with x64():
        ref_fs, ref_w = jkruskal.cp_normalize(jl(us))
        ref_fs, ref_w = [n(u) for u in ref_fs], n(ref_w)
    close(w, ref_w, rtol=RTOL_CLOSED)
    for u, r in zip(nfs, ref_fs):
        close(u, r, rtol=RTOL_CLOSED)
    # a zero column stays zero instead of dividing by zero
    z = us[0].copy()
    z[:, 1] = 0.0
    zf, zw = kruskal.cp_normalize([t(z), t(us[1])])
    assert float(zw[1]) == 0.0 and bool(torch.isfinite(zf[0]).all())


def test_create_problem_noise_level():
    prob = kruskal.create_problem(
        torch.Generator().manual_seed(0), (6, 7, 8), rank=2, noise=0.1, device="cpu"
    )
    rel = float(
        torch.linalg.vector_norm(prob["data"] - prob["clean"])
        / torch.linalg.vector_norm(prob["clean"])
    )
    np.testing.assert_allclose(rel, 0.1, rtol=1e-4)
    assert [tuple(u.shape) for u in prob["factors"]] == [(6, 2), (7, 2), (8, 2)]
    assert prob["data"].dtype == torch.float32
    # the same keys as the reference's, and `clean` is the factors' tensor
    ref = jkruskal.create_problem(jax.random.PRNGKey(0), (6, 7, 8), rank=2, noise=0.1)
    assert set(prob) == set(ref)
    close(prob["clean"], np_ktensor_full([n(u) for u in prob["factors"]]), rtol=1e-5)
    # one seed, one draw
    again = kruskal.create_problem(
        torch.Generator().manual_seed(0), (6, 7, 8), rank=2, noise=0.1, device="cpu"
    )
    np.testing.assert_array_equal(n(again["data"]), n(prob["data"]))


def test_tenrand_range():
    x = kruskal.tenrand(torch.Generator().manual_seed(0), (4, 5, 6), device="cpu")
    assert tuple(x.shape) == (4, 5, 6) and x.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    x64_ = kruskal.tenrand(None, (4, 5), dtype=torch.float64, device="cpu")
    assert x64_.dtype == torch.float64 and x64_.device.type == "cpu"


# --- what the port adds: loop edges, the solve, the contraction order --------


def test_max_iters_zero_returns_the_init():
    """The loop condition is tested before the first body, as the
    reference's while_loop does: no sweep, fit = -inf."""
    shape, rank = (5, 4, 3), 2
    x = rng(1).standard_normal(shape)
    init = random_factors(shape, rank, seed=2, kind="uniform")
    res, ref = _cp_als_both(x, rank, init, max_iters=0, tol=1e-4)
    assert res["n_iters"] == 0 == ref["n_iters"]
    assert float(res["fit"]) == -np.inf == ref["fit"]
    close(kruskal.ktensor_full(res["factors"], res["weights"]), np_ktensor_full(init), rtol=1e-12)
    hooi = decomp.tucker_hooi(t(x), (2, 2, 2), max_iters=0)
    with x64():
        ref_hooi = jdecomp.tucker_hooi(j(x), (2, 2, 2), max_iters=0)
        assert int(ref_hooi["n_iters"]) == 0 and float(ref_hooi["fit"]) == -np.inf
    assert hooi["n_iters"] == 0 and float(hooi["fit"]) == -np.inf


def test_spd_solve_matches_numpy_and_gives_nan_on_failure():
    g = rng(3)
    a = g.standard_normal((6, 4))
    gram, rhs = a.T @ a, g.standard_normal((5, 4))
    jitter = 32 * np.finfo(np.float64).eps * (np.trace(gram) / 4 + 1.0)
    want = rhs @ np.linalg.inv(gram + jitter * np.eye(4))
    close(decomp._spd_solve_rows(t(gram), t(rhs)), want, rtol=1e-9)
    # an indefinite matrix: NaN, as jax.scipy.linalg.cho_factor gives, no raise
    bad = np.diag([1.0, -1.0, 1.0, 1.0])
    out = decomp._spd_solve_rows(t(bad), t(rhs))
    assert bool(torch.isnan(out).any())


@pytest.mark.parametrize("shape", [(7, 3, 5), (3, 9, 4), (4, 5, 11), (3, 4, 5, 6), (6, 5)])
def test_mttkrp_every_mode_whatever_the_largest(shape):
    """The first GEMM goes over the largest other mode, which moves with the
    shape: every position of it, 2- to 4-way, against the reference."""
    factors = random_factors(shape, 3, seed=5)
    x = rng(6).standard_normal(shape)
    for mode in range(len(shape)):
        with x64():
            ref = n(jdecomp.mttkrp(j(x), jl(factors), mode))
        got = decomp.mttkrp(t(x), tl(factors), mode)
        assert tuple(got.shape) == (shape[mode], 3)
        close(got, ref, rtol=RTOL_CLOSED)


@pytest.mark.parametrize("transpose", [False, True])
def test_tucker_ttm_matches_reference_and_skips_none(transpose):
    g = rng(8)
    x = g.standard_normal((6, 5, 4))
    us = [g.standard_normal((6, 2) if transpose else (2, 6)),
          g.standard_normal((5, 7) if transpose else (7, 5)),
          g.standard_normal((4, 3) if transpose else (3, 4))]
    with x64():
        ref = n(jdecomp.tucker_ttm(j(x), jl(us), transpose=transpose))
        eye = jnp.eye(5)
        ref_skip = n(jdecomp.tucker_ttm(j(x), [j(us[0]), eye, j(us[2])], transpose=transpose))
    close(decomp.tucker_ttm(t(x), tl(us), transpose=transpose), ref, rtol=RTOL_CLOSED)
    tus = tl(us)
    tus[1] = None
    close(decomp.tucker_ttm(t(x), tus, transpose=transpose), ref_skip, rtol=RTOL_CLOSED)


def test_leading_basis_projector_matches_reference():
    x = rng(9).standard_normal((7, 6, 5))
    for mode in range(3):
        with x64():
            ref = projector(jdecomp._leading_basis(j(x), mode, 3))
        u = decomp._leading_basis(t(x), mode, 3)
        assert u.is_contiguous() or u.stride(1) > 0  # flip, not a negative stride
        close(projector(u), ref, rtol=RTOL_ITER)


def test_results_are_on_the_input_device_and_dtype():
    x = t(rng(1).standard_normal((5, 4, 3)), torch.float32)
    res = decomp.cp_als(x, 2, max_iters=3)
    assert all(u.dtype == torch.float32 and u.device == x.device for u in res["factors"])
    assert isinstance(res["n_iters"], int) and res["fit"].ndim == 0
    hs = decomp.tucker_hooi(x, (2, 2, 2), max_iters=2)
    assert hs["core"].dtype == torch.float32 and isinstance(hs["n_iters"], int)


# --- the whole path, problem to score ----------------------------------------


def test_problem_to_score_matches_reference():
    """create_problem's numbers -> cp_als -> ktensor_arrange -> ktensor_score
    against the truth, through both packages: the same score to 1e-8."""
    shape, rank = (10, 9, 8), 3
    prob = kruskal.create_problem(
        torch.Generator().manual_seed(5), shape, rank, noise=0.01, dtype=torch.float64,
        device="cpu",
    )
    truth = [n(u) for u in prob["factors"]]
    data = n(prob["data"])
    # the init both take: each unfolding's leading left singular vectors
    init = [
        np.linalg.svd(np.moveaxis(data, m, 0).reshape(s, -1), full_matrices=False)[0][:, :rank]
        for m, s in enumerate(shape)
    ]

    res = decomp.cp_als(t(data), rank, max_iters=100, tol=1e-10, init_factors=tl(init))
    w, fs = tenutils.ktensor_arrange(res["weights"], res["factors"])
    score = float(tenutils.ktensor_score(w, fs, torch.ones(rank, dtype=torch.float64), tl(truth)))

    with x64():
        ref = jdecomp.cp_als(j(data), rank, max_iters=100, tol=1e-10, init_factors=jl(init))
        rw, rfs = jtenutils.ktensor_arrange(ref["weights"], ref["factors"])
        ref_score = float(jtenutils.ktensor_score(rw, rfs, jnp.ones(rank), jl(truth)))
        ref_iters = int(ref["n_iters"])
        ref_w = n(rw)

    assert res["n_iters"] == ref_iters
    close(w, ref_w, rtol=RTOL_ITER)
    np.testing.assert_allclose(score, ref_score, atol=1e-8)
    # the fit is good; the score carries the weight penalty against the
    # truth's unit weights, so it is only held to the reference's
    assert float(res["fit"]) > 0.98
