"""PyTorch port: the one-sided Jacobi SVD of `ops/device_linalg.py` on the
CPU, through its plain version `jacobi_svd_torch` (the kernel,
`csrc/jacobi_svd.cu`, runs on the card only: `tests/test_torch_cuda.py`,
smoke phase 9).

Held at float64 to `torch.linalg.svd` and to the JAX package's
`jnp.linalg.svd` on numpy inputs from a seed: |ds| <= 1e-12 s_max, the
reconstruction within 1e-12 ||A|| (Frobenius), the vectors orthonormal to
1e-12, and each singular vector equal up to sign where its gap to the
neighbouring singular values exceeds 1e-6 s_max, within the first-order
perturbation bound 1e-12 s_max / gap (at least 1e-12). The columns of the side made from the
tall form's columns that belong to a zero singular value are zero (U is
W / s where s is not 0), so that side's orthonormality is held on the
columns of nonzero singular values; torch and JAX complete it to a basis.
The `svd` SVT route through the plain version is held to the JAX package's
`svt_ref_compat(..., method="svd")` and `svt(..., "svd")` at atol 1e-10
||M||. Then the driver choice at the limit, the plan and tournament the
kernel shares, and the ctypes declarations against the source.
"""

import importlib
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu_torch.baselines import device_loop  # noqa: E402
from tritd_tpu_torch.ops import device_linalg, hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops.device_linalg import JACOBI_LIMITS, LAPACK_SWEEPS  # noqa: E402
from tritd_tpu_torch.runtime import build, kernels  # noqa: E402
from tritd_tpu_torch.tools import jacobi_sweeps  # noqa: E402

jsvt, tsvt = (importlib.import_module(f"{p}.ops.svt") for p in ("tritd_tpu", "tritd_tpu_torch"))

TOL = 1e-12
GAP = 1e-6
SVT_ATOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_spectrum(p, q, spectrum, seed):
    rng = np.random.default_rng(seed)
    k = min(p, q)
    u = np.linalg.qr(rng.standard_normal((p, k)))[0]
    v = np.linalg.qr(rng.standard_normal((q, k)))[0]
    return (u * np.asarray(spectrum, dtype=np.float64)) @ v.T


def _matrix(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "tall":
        return rng.standard_normal((60, 20))
    if name == "wide":
        return rng.standard_normal((20, 60))
    if name == "square":
        return rng.standard_normal((33, 33))
    if name == "k1 tall":
        return rng.standard_normal((25, 1))
    if name == "k1 wide":
        return rng.standard_normal((1, 25))
    if name == "rank deficient":
        return rng.standard_normal((40, 5)) @ rng.standard_normal((5, 30))
    if name == "repeated":
        return _with_spectrum(45, 24, [5.0] * 4 + [3.0] * 6 + [2.0] * 3 + list(np.linspace(1.5, 0.1, 11)), 3)
    if name == "zero":
        return np.zeros((12, 9))
    if name == "1000 wide":
        return rng.standard_normal((8, 1000))
    raise ValueError(name)


CASES = ("tall", "wide", "square", "k1 tall", "k1 wide", "rank deficient", "repeated", "zero", "1000 wide")


def _check_against(a, got, want):
    """`got` (u, s, vh) of `a` held to `want` (u, s, vh, numpy float64)."""
    u, s, vh = (np.asarray(x, dtype=np.float64) for x in got)
    wu, ws, wvh = want
    k = min(a.shape)
    smax = float(ws[0])
    assert u.shape == (a.shape[0], k) and s.shape == (k,) and vh.shape == (k, a.shape[1])
    assert np.all(np.diff(s) <= 0)
    assert np.max(np.abs(s - ws)) <= TOL * smax
    assert np.linalg.norm((u * s) @ vh - a) <= TOL * np.linalg.norm(a)
    nonzero = s > 0
    tall = a.shape[0] >= a.shape[1]
    # the side made from the tall form's columns: u for a tall input, vh for a wide one
    made, other = (u[:, nonzero], vh.T) if tall else (vh[nonzero].T, u)
    for basis in (made, other):
        if basis.shape[1]:
            assert np.max(np.abs(basis.T @ basis - np.eye(basis.shape[1]))) <= TOL
    assert np.all((u if tall else vh.T)[:, ~nonzero] == 0)
    padded = np.concatenate([[np.inf], ws, [np.inf]])
    for i in range(k):
        gap = min(abs(padded[i + 1] - padded[i]), abs(padded[i + 1] - padded[i + 2]))
        if smax == 0 or gap <= GAP * smax:
            continue
        atol = TOL * max(1.0, smax / gap)
        for mine, theirs in ((u[:, i], wu[:, i]), (vh[i], wvh[i])):
            sign = np.sign(mine @ theirs) or 1.0
            assert np.max(np.abs(mine - sign * theirs)) <= atol


@pytest.mark.parametrize("name", CASES)
def test_plain_jacobi_matches_torch_and_jax_at_float64(name):
    a = _matrix(name)
    got = device_linalg.jacobi_svd_torch(torch.from_numpy(a))
    tu, ts, tvh = torch.linalg.svd(torch.from_numpy(a), full_matrices=False)
    _check_against(a, got, (tu.numpy(), ts.numpy(), tvh.numpy()))
    with jax.enable_x64(True):
        ju, js, jvh = jnp.linalg.svd(jnp.asarray(a), full_matrices=False)
        want = (np.asarray(ju), np.asarray(js), np.asarray(jvh))
    _check_against(a, got, want)


@pytest.mark.parametrize("name", ["tall", "wide", "repeated"])
def test_plain_jacobi_at_float32(name):
    """float32 (its inner rotations in float64) within 64 k eps of
    torch.linalg.svd's float64 values and orthonormal to the rotation
    test's tolerance, sqrt(k) eps, and 64 k eps."""
    a = _matrix(name)
    a32 = torch.from_numpy(a).float()
    u, s, vh = (x.double() for x in device_linalg.jacobi_svd_torch(a32))
    assert u.dtype == s.dtype == vh.dtype == torch.float64
    want = torch.linalg.svd(a32.double(), full_matrices=False)[1]
    k = min(a.shape)
    eps = torch.finfo(torch.float32).eps
    bound = 64 * k * eps
    assert float((s - want).abs().max()) <= bound * float(want[0])
    assert float(torch.linalg.matrix_norm((u * s) @ vh - a32.double())) <= bound * float(torch.linalg.matrix_norm(a32.double()))
    for basis in (u, vh.mT):
        assert float((basis.mT @ basis - torch.eye(k, dtype=torch.float64)).abs().max()) <= (
            device_linalg.jacobi_tol(k, torch.float32) + bound)


def test_the_tolerance_does_not_grow_with_the_tall_side(monkeypatch):
    """The rotation test's tolerance is sqrt(k) eps of the dtype, the same
    for a given thin side k whatever the tall side m; the plain version
    passes it the thin side, of a tall input and of a wide one."""
    for dtype in (torch.float32, torch.float64):
        eps = torch.finfo(dtype).eps
        for k in (1, 64, 240, 1024):
            assert device_linalg.jacobi_tol(k, dtype) == k ** 0.5 * eps
    seen = []
    tol = device_linalg.jacobi_tol
    monkeypatch.setattr(device_linalg, "jacobi_tol", lambda k, dtype: seen.append(k) or tol(k, dtype))
    a = torch.from_numpy(np.random.default_rng(4).standard_normal((3000, 24)))
    for x in (a, a.mT.contiguous()):
        device_linalg.jacobi_svd_torch(x)
    assert seen == [24, 24]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_jacobi_float32_at_a_long_tall_side(seed):
    """Zero columns among standard normal ones (every fifth column zero) at
    96000 x 64 in float32, the video cut's tall side: the singular values
    within 4e-7 s_max of torch.linalg.svdvals of the same matrix in float64,
    in at most 8 sweeps. With LAPACK gesvj's tolerance sqrt(m) eps (1.2e-5
    at m = 96000) the sweeps stopped at 7.5e-7 to 1.4e-6 s_max on these
    seeds; sqrt(k) eps reads 1.0e-7 to 1.5e-7 (PERF.md section 6)."""
    a_np = jacobi_sweeps.exact_matrix("zero-cols", 96000, 64, np.random.default_rng(seed))
    a = torch.from_numpy(a_np).float()
    _u, s, _vh, sweeps = device_linalg._jacobi_torch(a)
    want = torch.linalg.svdvals(a.double())
    assert sweeps <= 8
    assert float((s.double() - want).abs().max()) <= 4e-7 * float(want[0])


def test_the_sweeps_stop_at_the_first_without_a_rotation():
    """A matrix whose columns are already orthogonal takes one sweep; a
    random one more, and fewer than the cap."""
    a = torch.from_numpy(_matrix("tall"))
    u, s, vh, sweeps = device_linalg._jacobi_torch(a)
    assert 1 < sweeps < device_linalg.JACOBI_SWEEPS
    assert device_linalg._jacobi_torch((u * s).contiguous())[3] == 1
    assert device_linalg._jacobi_torch(torch.zeros(7, 5, dtype=torch.float64))[3] == 1


@pytest.mark.parametrize("shape", [(400, 120), (120, 400)], ids=str)
@pytest.mark.parametrize("case", ["graded", "clustered", "rank-def"])
def test_plain_jacobi_converges_on_the_cap_readings_spectra(case, shape):
    """The spectra the cap was set from (`tools/jacobi_sweeps`: s_i =
    10^(-8 i / k), groups of 8 equal values, rank k / 4 and an eps tail),
    at a small size: the plain version converges under JACOBI_SWEEPS and
    matches torch.linalg.svd and jnp.linalg.svd at float64 with the
    tolerances above (vectors only where their gap exceeds 1e-6 s_max)."""
    p, q = shape
    k = min(shape)
    s = jacobi_sweeps.spectrum(case, k, np.finfo(np.float64).eps)
    a = _with_spectrum(p, q, s, sum(map(ord, case)))
    u, sv, vh, sweeps = device_linalg._jacobi_torch(torch.from_numpy(a))
    assert 1 < sweeps < device_linalg.JACOBI_SWEEPS
    tu, ts, tvh = torch.linalg.svd(torch.from_numpy(a), full_matrices=False)
    _check_against(a, (u, sv, vh), (tu.numpy(), ts.numpy(), tvh.numpy()))
    with jax.enable_x64(True):
        ju, js, jvh = jnp.linalg.svd(jnp.asarray(a), full_matrices=False)
        want = (np.asarray(ju), np.asarray(js), np.asarray(jvh))
    _check_against(a, (u, sv, vh), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(jacobi_sweeps.EXACT_SMALL))
def test_plain_jacobi_converges_on_exactly_rank_deficient_matrices(name, dtype):
    """The matrices whose rounding columns rotated against each other in
    every sweep up to the cap before the rotation test's floor
    (`device_linalg.JACOBI_ROUNDING`): an integer outer product and its
    transpose, static clips (one column repeated), rank 3 from duplicated
    columns, zero columns among random ones. The plain version converges
    within LAPACK's 30 sweeps; its singular values are within
    JACOBI_LIMITS s_max of torch.linalg.svd of the same matrix in float64
    (a negligible one returned as 0), the reconstruction within that times
    sqrt(k) s_max (Frobenius), the side made of the accumulated rotations
    (V of a tall input) orthogonal and the other orthonormal on the
    nonzero values, its columns of zero values zero, within sqrt(k) eps +
    JACOBI_LIMITS."""
    a = torch.from_numpy(jacobi_sweeps.exact_small(name)).to(dtype)
    u, s, vh, sweeps = device_linalg._jacobi_torch(a)
    assert sweeps <= LAPACK_SWEEPS
    a64 = a.double()
    ref = torch.linalg.svd(a64, full_matrices=False)[1]
    k = min(a.shape)
    bound, smax = JACOBI_LIMITS[dtype], float(ref[0])
    u, s, vh = u.double(), s.double(), vh.double()
    assert float((s - ref).abs().max()) <= bound * smax
    assert float(torch.linalg.matrix_norm((u * s) @ vh - a64)) <= bound * smax * k ** 0.5
    tall = a.shape[0] >= a.shape[1]
    rotations, made = (vh.mT, u) if tall else (u, vh.mT)
    nonzero = s > 0
    close = device_linalg.jacobi_tol(k, dtype) + bound
    eye = torch.eye(k, dtype=torch.float64)
    assert float((rotations.mT @ rotations - eye).abs().max()) <= close
    kept = made[:, nonzero]
    assert float((kept.mT @ kept - eye[:kept.shape[1], :kept.shape[1]]).abs().max()) <= close
    assert torch.equal(made[:, ~nonzero], torch.zeros_like(made[:, ~nonzero]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_a_negligible_singular_value_is_zero_with_a_zero_vector(dtype):
    """A singular value below JACOBI_NEGLIGIBLE eps s_max is returned as 0
    and its column of the side made from the tall form's columns is zero
    (U of a tall input, V of a wide one); one above it is kept, its
    vector unit."""
    eps = torch.finfo(dtype).eps
    below, above = 0.5 * device_linalg.JACOBI_NEGLIGIBLE * eps, 4 * device_linalg.JACOBI_NEGLIGIBLE * eps
    a_np = _with_spectrum(50, 12, [1.0] * 10 + [above, below], 5)
    for a in (torch.from_numpy(a_np).to(dtype), torch.from_numpy(a_np.T.copy()).to(dtype)):
        u, s, vh = device_linalg.jacobi_svd_torch(a)
        made = u if a.shape[0] >= a.shape[1] else vh.mT
        assert float(s[-1]) == 0.0 and torch.equal(made[:, -1], torch.zeros_like(made[:, -1]))
        assert abs(float(s[-2]) / above - 1) < 0.5
        assert abs(float(torch.linalg.vector_norm(made[:, -2].double())) - 1) < 1e-3


@pytest.mark.parametrize("shape", [(400, 120), (120, 400)], ids=str)
@pytest.mark.parametrize("case", ["graded", "clustered", "rank-def"])
def test_the_floor_keeps_the_spectra_sweeps(case, shape):
    """The floor changes nothing that converged: at the cap readings'
    spectra the plain version takes no more sweeps than without it (within
    2), in float32 and float64 (without it: the floor set to 0 and nothing
    negligible)."""
    p, q = shape
    a_np = _with_spectrum(p, q, jacobi_sweeps.spectrum(case, min(shape), np.finfo(np.float64).eps),
                          sum(map(ord, case)))
    for dtype in (torch.float32, torch.float64):
        a = torch.from_numpy(a_np).to(dtype)
        with_floor = device_linalg._jacobi_torch(a)[3]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(device_linalg, "jacobi_floor", lambda _dtype: 0.0)
            mp.setattr(device_linalg, "jacobi_negligible", lambda _dtype: 0.0)
            without = device_linalg._jacobi_torch(a)[3]
        assert with_floor <= without + 2 < device_linalg.JACOBI_SWEEPS


@pytest.mark.parametrize("shape", [(400, 120), (120, 400)], ids=str)
def test_the_floor_costs_float32_at_most_three_times_its_level(shape):
    """The floor's cost in accuracy: a singular value up to about 3 times
    the floor (JACOBI_ROUNDING eps s_max) can be spread over columns each
    under it and lost. On a graded float32 spectrum (down to 1e-8 s_max)
    the plain version's values are within 3 JACOBI_ROUNDING eps s_max of
    torch.linalg.svd in float64 (here 4.0e-6 and 4.6e-6 s_max at a 16 eps
    floor, 1.2e-6 and 1.0e-6 at 4), well within JACOBI_LIMITS."""
    p, q = shape
    k = min(shape)
    a_np = _with_spectrum(p, q, jacobi_sweeps.spectrum("graded", k, np.finfo(np.float64).eps), 7)
    ref = torch.linalg.svd(torch.from_numpy(a_np), full_matrices=False)[1]
    s = device_linalg.jacobi_svd_torch(torch.from_numpy(a_np).float())[1].double()
    eps = torch.finfo(torch.float32).eps
    bound = 3 * device_linalg.JACOBI_ROUNDING * eps
    assert bound < JACOBI_LIMITS[torch.float32]
    assert float((s - ref).abs().max()) <= bound * float(ref[0])


def test_svt_of_the_outer_product_through_the_plain_jacobi_matches_jax(monkeypatch):
    """The `svd` SVT route with its SVD the plain Jacobi (on the card the
    kernel) on the 40 x 30 integer outer product, which stopped at the cap
    before the floor, against the JAX package's, both operators, at atol
    SVT_ATOL ||M|| (float64; tau below and above s_max)."""
    m = jacobi_sweeps.exact_small("outer 40x30")
    monkeypatch.setattr(tsvt.device_linalg, "svd", device_linalg.jacobi_svd_torch)
    atol = SVT_ATOL * np.linalg.norm(m)
    for tau in (100.0, 2e4):
        with jax.enable_x64(True):
            want_compat = np.asarray(jsvt.svt_ref_compat(jnp.asarray(m), tau, method="svd"))
            want_plain = np.asarray(jsvt.svt(jnp.asarray(m), tau, "svd"))
        got_compat = tsvt.svt_ref_compat(torch.from_numpy(m), tau, method="svd").numpy()
        got_plain = tsvt.svt(torch.from_numpy(m), tau, "svd").numpy()
        np.testing.assert_allclose(got_compat, want_compat, rtol=0, atol=atol)
        np.testing.assert_allclose(got_plain, want_plain, rtol=0, atol=atol)


def _svt_input(p, q, seed):
    k = min(p, q)
    return _with_spectrum(p, q, np.concatenate([np.linspace(40.0, 6.0, k // 3), np.linspace(2.9, 0.05, k - k // 3)]),
                          seed)


@pytest.mark.parametrize("shape", [(40, 90), (90, 40), (30, 30)])
def test_svd_route_through_the_plain_version_matches_jax(shape, monkeypatch):
    """The SVT's svd route with its SVD the plain Jacobi (on the card the
    kernel) against the JAX package's svd route: both the ref-compat
    operator (>1 gate) and plain soft-thresholding, tau between the
    spectrum's values."""
    m = _svt_input(*shape, seed=shape[0])
    monkeypatch.setattr(tsvt.device_linalg, "svd", device_linalg.jacobi_svd_torch)
    atol = SVT_ATOL * np.linalg.norm(m)
    for tau in (2.0, 0.5):
        with jax.enable_x64(True):
            want_compat = np.asarray(jsvt.svt_ref_compat(jnp.asarray(m), tau, method="svd"))
            want_plain = np.asarray(jsvt.svt(jnp.asarray(m), tau, "svd"))
        got_compat = tsvt.svt_ref_compat(torch.from_numpy(m), tau, method="svd").numpy()
        got_plain = tsvt.svt(torch.from_numpy(m), tau, "svd").numpy()
        np.testing.assert_allclose(got_compat, want_compat, rtol=0, atol=atol)
        np.testing.assert_allclose(got_plain, want_plain, rtol=0, atol=atol)


@pytest.mark.parametrize("p, q, want", [(1024, 5000, "jacobi"), (1025, 5000, "gesvdj"), (5000, 1024, "jacobi"),
                                        (5000, 1025, "gesvdj"), (1, 7, "jacobi"), (4800, 4800, "gesvdj")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_svd_driver_at_the_limit(p, q, want, dtype):
    """Up to a thin side of SVD_JACOBI_MAX_K the Jacobi SVD, which a graph
    captures; past it gesvdj, which none does: the svd route of a loop
    with such an unfolding takes the eager loop on the card."""
    assert device_linalg.SVD_JACOBI_MAX_K == 1024
    assert device_linalg.svd_driver(p, q, dtype) == want
    assert device_linalg.svd_captures(p, q) is (want == "jacobi")
    assert tsvt.captures("svd", [(p, q)]) is (want == "jacobi")
    cuda = torch.device("cuda", 0)
    assert device_loop.route(cuda, "svd", [(100, 50000), (p, q)]) is (True if want == "jacobi" else None)
    assert device_linalg.SVD_DRIVERS == ("jacobi", "gesvdj")


@pytest.mark.parametrize("n", [2, 4, 8, 32, 64])
def test_tournament_meets_every_pair_once_in_disjoint_rounds(n):
    rounds = device_linalg.jacobi_tournament(n)
    assert len(rounds) == n - 1 and all(len(r) == n // 2 for r in rounds)
    for r in rounds:
        assert sorted(x for pair in r for x in pair) == list(range(n))
    met = [frozenset(pair) for r in rounds for pair in r]
    assert len(set(met)) == len(met) == n * (n - 1) // 2


@pytest.mark.parametrize("nb", [2, 4, 8, 64])
def test_a_sweep_rotates_every_pair_of_columns_once(nb):
    """The inner rounds (every pair of the 32 indices at an outer sweep's
    first round, the 256 across the two blocks after), each of disjoint
    pairs, met with the outer tournament: every pair of the nb * 16
    columns once a sweep, the cyclic Jacobi ordering by blocks."""
    b = device_linalg.JACOBI_BLOCK
    met = []
    for r, rnd in enumerate(device_linalg.jacobi_tournament(nb)):
        inner = device_linalg.jacobi_inner_rounds(r == 0)
        assert len(inner) == (2 * b - 1 if r == 0 else b)
        for pairs in inner:
            assert sorted(x for pair in pairs for x in pair) == list(range(2 * b))
        for blocks in rnd:
            cols = [blocks[0] * b + i for i in range(b)] + [blocks[1] * b + i for i in range(b)]
            met += [frozenset((cols[x], cols[y])) for pairs in inner for x, y in pairs]
    assert len(met) == len(set(met)) == nb * b * (nb * b - 1) // 2


@pytest.mark.parametrize("p, q", [(100, 50000), (10000, 500), (50000, 100), (5000, 1000), (1000, 5000), (500, 10000),
                                  (1, 1), (17, 3), (3, 70), (1024, 1100)])
@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_plan_covers_the_matrix(p, q, sms, dtype):
    """The plan covers the matrix on a card of `sms` SMs: every tile in a
    CTA's slice, the slice resident in one stage or cut into balanced
    chunks of a ring of up to JACOBI_RING, a CTA's shared memory within the H100's
    232,448 bytes, clusters of at most 16 CTAs in teams of at most 8, a
    team a pair (or clusters of one CTA, several pairs each), at least
    JACOBI_MIN_SLICE tiles a CTA where the matrix has them, and every CTA
    of the grid resident at once (one an SM: the grid barrier waits for
    all of them)."""
    plan = device_linalg.jacobi_plan(p, q, sms, dtype)
    k, m = min(p, q), max(p, q)
    assert (plan.k, plan.m, plan.wide, plan.ldv) == (k, m, p < q, k)
    assert plan.nb % 2 == 0 and plan.nb >= 2 and plan.nb * device_linalg.JACOBI_BLOCK >= k
    assert (plan.nb - 2) * device_linalg.JACOBI_BLOCK < k
    assert plan.ldw % device_linalg.JACOBI_TILE == 0 and m <= plan.ldw < m + device_linalg.JACOBI_TILE
    tiles, pairs = plan.ldw // device_linalg.JACOBI_TILE, plan.nb // 2
    slices = plan.cluster * plan.team
    assert 1 <= plan.cluster <= device_linalg.JACOBI_MAX_CLUSTER and 1 <= plan.team <= device_linalg.JACOBI_MAX_TEAM
    assert slices <= max(1, tiles // device_linalg.JACOBI_MIN_SLICE)
    assert plan.clusters == pairs * plan.team or (plan.team == plan.cluster == 1 and plan.clusters < pairs)
    assert plan.clusters * plan.cluster <= sms
    per = -(-tiles // slices)
    size = torch.finfo(dtype).bits // 8
    row = plan.chunk * device_linalg.JACOBI_TILE + device_linalg.JACOBI_PAD
    assert plan.smem == device_linalg.JACOBI_FIXED_SMEM[dtype] + plan.stages * 32 * row * size
    assert plan.smem <= device_linalg.JACOBI_SMEM_LIMIT == 232448
    if plan.stages == 1:
        assert plan.chunk == per
    else:
        chunks = -(-per // plan.chunk)
        assert 2 <= plan.stages <= device_linalg.JACOBI_RING and plan.chunk < per and (chunks - 1) * plan.chunk < per
        assert plan.chunk >= device_linalg.JACOBI_MIN_CHUNK or plan.stages == 2 or plan.chunk == per
        assert plan.chunk == -(-per // chunks)  # balanced
    if sms == 132 and (p, q) in ((100, 50000), (10000, 500), (5000, 1000)):
        assert plan.cluster * plan.clusters >= 128  # the taxi tall forms fill the card


def test_plan_takes_the_clusters_the_card_holds():
    """The H100 holds 7 clusters of 16, 15 of 8, 30 of 4, 66 of 2 (its SMs
    in GPCs of 16 to 18), fewer than 132 / size: the plan fills the card
    with the clusters it holds, in teams where it holds fewer large
    clusters than pairs (taxi's 16 and 32), and at 32 pairs on 16 SMs takes
    16 clusters of one CTA, two pairs each a round. `active` is
    cudaOccupancyMaxActiveClusters on the card."""
    held = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}

    def active(cluster, _smem):
        return held.get(cluster, 0)

    for (p, q), want in {(100, 50000): (4, 7, 112), (10000, 500): (2, 4, 128), (5000, 1000): (2, 2, 128)}.items():
        plan = device_linalg.jacobi_plan(p, q, 132, torch.float32, active)
        assert (plan.cluster, plan.team, plan.cluster * plan.clusters) == want
    plan = device_linalg.jacobi_plan(10000, 500, 132, torch.float32, active)
    assert plan.stages == 1  # 20 tiles a CTA: the slice resident
    plan = device_linalg.jacobi_plan(5000, 1000, 16, torch.float64, lambda cluster, _smem: 16 // cluster)
    assert (plan.cluster, plan.team, plan.clusters) == (1, 1, 16)  # 32 pairs on 16 SMs
    with pytest.raises(ValueError, match="no CTA"):
        device_linalg.jacobi_plan(100, 50000, 132, torch.float32, lambda _cluster, _smem: 0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Checked before the library is loaded, so on the CPU too."""
    a = torch.zeros(10, 4)
    with pytest.raises(ValueError, match="CUDA"):
        device_linalg.jacobi_svd(a)
    with pytest.raises(ValueError, match="float32 or float64"):
        device_linalg.jacobi_svd(torch.zeros(10, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32 or float64"):
        device_linalg.jacobi_svd(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="both sides"):
        device_linalg.jacobi_svd_torch(torch.zeros(0, 4))
    assert set(hopper_kernels.JACOBI_SVD_LAUNCHES) == {"jacobi_svd[f32]", "jacobi_svd[f64]"}


def _source():
    return (build.SRC_DIR / "jacobi_svd.cu").read_text()


def test_binding_declares_every_c_entry_with_its_parameters():
    counts = {fn: 0 if params.strip() in ("", "void") else params.count(",") + 1
              for fn, params in re.findall(r"^int (tritd_\w+)\(([^)]*)\)", _source(), re.M)}
    assert set(counts) == {"tritd_jacobi_block", "tritd_jacobi_tile", "tritd_jacobi_sweeps", "tritd_jacobi_fixed_smem",
                           "tritd_jacobi_active_clusters", "tritd_jacobi_svd_f32", "tritd_jacobi_svd_f64",
                           "tritd_jacobi_launches", "tritd_jacobi_phase_cycles"}  # the last only in a build with -DTRITD_JACOBI_TRACE
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in counts})
    kernels._bind_jacobi(lib)
    for name, n in counts.items():
        assert len(getattr(lib, name).argtypes) == n, name


def test_launch_counts_follow_jacobi_kernels():
    """The launcher counts each kernel under its index in
    `device_linalg.JACOBI_KERNELS` (the order `tritd_jacobi_launches`
    reports), each once, right after that kernel's launch."""
    src = _source()
    body = src[src.index("int jacobi_svd(const T* a"):]
    body = body[:body.index("#undef TRITD_LAUNCHED")]
    steps = re.findall(r"\b(\w+_kernel)<T>|TRITD_LAUNCHED\((\d+)\);", body)
    kernels_ = device_linalg.JACOBI_KERNELS
    assert steps == [s for i, name in enumerate(kernels_) for s in ((name, ""), ("", str(i)))]
    assert int(re.search(r"kKernels = (\d+)", src).group(1)) == len(kernels_)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_source_constants_are_the_modules():
    """The kernel's constants, its cap included, are the module's; the
    fixed part of a CTA's shared memory is its struct's size (a barrier a
    stage of the ring, two partial Grams and R in T, the inner pass's two G and two R in
    double, 16 rotations' c, s and new diagonal, the previous round's
    reference, their flags) rounded to 128 bytes."""
    src = _source()
    assert _constant(src, "kBlock") == device_linalg.JACOBI_BLOCK
    assert _constant(src, "kTile") == device_linalg.JACOBI_TILE
    assert _constant(src, "kSweeps") == device_linalg.JACOBI_SWEEPS == device_linalg.JACOBI_SWEEPS_BUILT
    assert _constant(src, "kPad") == device_linalg.JACOBI_PAD
    assert _constant(src, "kRing") == device_linalg.JACOBI_RING
    assert _constant(src, "kMaxTeam") == device_linalg.JACOBI_MAX_TEAM
    assert _constant(src, "kMaxCluster") == device_linalg.JACOBI_MAX_CLUSTER
    assert _constant(src, "kSmemLimit") == device_linalg.JACOBI_SMEM_LIMIT
    assert _constant(src, "kMaxPairs") == device_linalg.JACOBI_MAX_PAIRS
    assert int(re.search(r"kStateHead = (\d+)", src).group(1)) == device_linalg.JACOBI_STATE_HEAD
    b = device_linalg.JACOBI_BLOCK
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        fixed = (device_linalg.JACOBI_RING * 8 + 3 * (2 * b) ** 2 * size + 4 * (2 * b) * (2 * b + 1) * 8
                 + 4 * b * 8 + 8 + b * 4 + 4 * 4)
        assert device_linalg.JACOBI_FIXED_SMEM[dtype] == -(-fixed // 128) * 128
