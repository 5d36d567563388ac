"""PyTorch port, `storage_dtype` and `einsum_dtype` of "float32" or
"float64": the five cases the reference's `tritd_admm` runs (float32
storage or einsum at float32 compute, float64 storage at float32, float64
einsum at float64, float32 storage at float64), their masked forms, and one
cross case each way (float64 storage with a bf16 einsum at float32, float32
storage with a float16 einsum at float64). Each runs `tritd_admm` in both
packages from the same numpy init for 5 iterations; err_hist and the
factors are compared.

Tolerances. Where float32 rounding is in the run: rtol 1e-5 on err_hist,
and on the factors 1e-5 of their largest entry; the float32 solve itself
parts from the reference's by up to 8e-7 (err_hist) and 8e-6 (factors) at
this size, from the summation order of the contractions. The float64
einsum at float64 compute accumulates the right-hand sides in float32, as
the reference does (`ops/normal_eq.py`): held at the same 1e-5, measured
up to 3.6e-7 and 2.3e-6 over eight problem seeds. The cross cases round X
and the factors to a 2-byte einsum dtype in every mode solve, where one
flipped rounding moves a factor by a step of that dtype and the runs part
from there: after 5 iterations err_hist rtol 1e-3 (as
`tests/test_torch_narrow_dtypes.py` holds its narrow-einsum solves; up to
4.4e-3 read on other problems of this size) and factors 5e-2 of their
largest entry (largest reading 2.6e-2 over eight problem seeds, 1.4e-2 on
this one); after the first iteration, before a flip feeds back, err_hist
rtol 2e-6 and factors 5e-5 (largest readings over sixteen seeds: 8.1e-7
and 2.4e-5, the latter one float16 rounding of a small entry; a bf16 step
of the largest is 3.9e-3).

Also: the configuration's dtype rule (a storage name equal to cfg.dtype is
None; an einsum name equal to it keeps T' in cfg.dtype), the float64 einsum's
right-hand side within its float32 roundings of the reference's where no
summation order intervenes,
the kernel variant each configuration routes to, and a bitwise resume of a
checkpoint of float64 storage at float32 compute."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu.ops import normal_eq as jne  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers import tritd_admm as j_tritd_admm  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu.solvers.admm import t_dtype_of as j_t_dtype_of  # noqa: E402
from tritd_tpu_torch.data import make_completion_problem  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels, normal_eq  # noqa: E402
from tritd_tpu_torch.solvers import TriTDConfig, tritd_admm, tritd_admm_checkpointed  # noqa: E402
from tritd_tpu_torch.solvers.admm import t_dtype_of  # noqa: E402
from tritd_tpu_torch.utils import checkpoint  # noqa: E402

SHAPE = (12, 10, 14)
ITERS = 5
CASES = {
    "storage_f32_at_f32": dict(storage_dtype="float32"),
    "einsum_f32_at_f32": dict(einsum_dtype="float32"),
    "storage_f64_at_f32": dict(storage_dtype="float64"),
    "einsum_f64_at_f64": dict(einsum_dtype="float64", dtype="float64"),
    "storage_f32_at_f64": dict(storage_dtype="float32", dtype="float64"),
    "storage_f64_einsum_bf16_at_f32": dict(storage_dtype="float64", einsum_dtype="bfloat16"),
    "storage_f32_einsum_f16_at_f64": dict(storage_dtype="float32", einsum_dtype="float16", dtype="float64"),
}
CROSS = ("storage_f64_einsum_bf16_at_f32", "storage_f32_einsum_f16_at_f64")
F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fields: dict, masked: bool, iters: int = ITERS):
    """(port result, reference err_hist, reference factors) of one solve."""
    prob = make_completion_problem(np.random.default_rng(0), shape=SHAPE, rank=2,
                                   missing_ratio=0.3 if masked else 0.0)
    d, mask = prob["y"], prob["mask"]
    cfg = TriTDConfig(**{"rank": 2, "max_iter": iters, "tol": 0.0, "lambda_l1": 0.1, "masked": masked, **fields})
    with jax.enable_x64("float64" in fields.values()):
        jdt = getattr(jnp, cfg.dtype)
        init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, 2, jdt)]
        jres = j_tritd_admm(jnp.asarray(d, jdt), JConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0),
                            mask=jnp.asarray(mask) if masked else None)
        want = np.asarray(jres.err_hist), [np.asarray(getattr(jres, f)) for f in "abc"]
    res = tritd_admm(torch.from_numpy(d).to(cfg.torch_dtype()), cfg,
                     mask=torch.from_numpy(mask) if masked else None, init=init)
    return res, *want


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("case", list(CASES))
def test_wide_solve_matches_jax(case, masked):
    res, want, want_factors = _both(CASES[case], masked)
    cd = res.a.dtype
    assert cd == getattr(torch, CASES[case].get("dtype", "float32"))
    assert res.o.dtype == res.e.dtype == res.err_hist.dtype == cd and res.n_iters == ITERS
    got = res.err_hist.numpy()
    assert np.isfinite(got).all() and got[-1] < got[0]
    hist_rtol, factor_rtol = (1e-3, 5e-2) if case in CROSS else (1e-5, 1e-5)
    _hold(res, want, want_factors, hist_rtol, factor_rtol)
    if case in CROSS:
        # the first iteration, before a flipped einsum rounding feeds back
        _hold(*_both(CASES[case], masked, iters=1), 2e-6, 5e-5)


def _hold(res, want, want_factors, hist_rtol, factor_rtol):
    np.testing.assert_allclose(res.err_hist.numpy(), want, rtol=hist_rtol)
    for f, w in zip("abc", want_factors):
        g = getattr(res, f).numpy()
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=factor_rtol, atol=factor_rtol * np.abs(w).max(), err_msg=f)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("einsum", [None, "bfloat16", "float32", "float64"])
@pytest.mark.parametrize("storage", [None, "float16", "float32", "float64"])
def test_dtype_rule_matches_jax(storage, einsum, dtype):
    """t_dtype_of as the reference's; a storage name equal to cfg.dtype
    stores in cfg.dtype (the reference's None); an einsum name is kept,
    cfg.dtype included."""
    cfg = TriTDConfig(rank=2, storage_dtype=storage, einsum_dtype=einsum, dtype=dtype)
    want = j_t_dtype_of(JConfig(**dataclasses.asdict(cfg)))
    got = t_dtype_of(cfg)
    assert (got is None and want is None) or str(got).removeprefix("torch.") == str(want)
    assert cfg.torch_storage_dtype() == getattr(torch, storage or dtype)
    assert cfg.torch_einsum_dtype() == (None if einsum is None else getattr(torch, einsum))


@pytest.mark.parametrize("compute", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_float64_einsum_rhs_is_the_references_within_its_roundings_on_single_terms(mode, compute):
    """With one term in each sum (the contracted indices of size 1) no
    summation order intervenes, and the right-hand side of a float64 einsum
    dtype parts from the reference's only by its roundings to float32, each
    at most 2**-24 relative. XLA pairs the cores in float64 and rounds the
    pair, rounds X and rounds the product (two roundings at float32
    compute, where X is exact, three at float64); the port rounds X and
    the cores (none at float32 compute, three at float64) and then X C and
    its product with B (two). So each entry is within 4 (float32 compute)
    or 8 (float64) such units of the reference's, plus one for the
    second-order terms."""
    rng = np.random.default_rng(mode)
    shape = [1, 1, 1]
    shape[mode - 1] = 40
    n1, n2, n3 = shape
    r = 4
    args = [rng.standard_normal(s).astype(compute) for s in (shape, (n1, r, r), (r, n2, r), (r, r, n3))]
    with jax.enable_x64(True):
        want = np.asarray(jne.rhs_mode(mode, *map(jnp.asarray, args), einsum_dtype=jnp.float64))
    got = normal_eq.rhs_mode(mode, *map(torch.from_numpy, args), einsum_dtype=F64).numpy()
    assert got.dtype == want.dtype == compute
    units = 5 if compute == np.float32 else 9
    np.testing.assert_allclose(got, want, rtol=units * 2.0**-24, atol=0)


@pytest.mark.parametrize("variant", ["hadamard", "full"])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_float64_einsum_rhs_matches_jax(mode, variant):
    """At float64 compute the right-hand side carries float32's precision,
    in both packages: rtol 1e-6 of the largest entry (summation order)."""
    rng = np.random.default_rng(10 + mode)
    r = 3
    args = [rng.standard_normal(s) for s in ((6, 7, 8), (6, r, r), (r, 7, r), (r, r, 8))]
    with jax.enable_x64(True):
        want = np.asarray(jne.rhs_mode(mode, *map(jnp.asarray, args), variant=variant, einsum_dtype=jnp.float64))
    got = normal_eq.rhs_mode(mode, *map(torch.from_numpy, args), variant=variant, einsum_dtype=F64).numpy()
    exact = normal_eq.rhs_mode(mode, *map(torch.from_numpy, args), variant=variant).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # and it is not the float64 contraction: float32's rounding is there
    assert np.abs(got - exact).max() > 1e-12 * np.abs(exact).max()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("case", list(CASES))
def test_each_configuration_routes_to_its_variant(case, masked):
    """The dtypes a solve hands the block (the imputed D in the compute
    dtype when masked, no T' then) name one kernel variant; on CPU tensors
    the CUDA wrapper gets past the choice and stops at the device."""
    cfg = TriTDConfig(rank=2, masked=masked, **CASES[case])
    cd, sd, td = cfg.torch_dtype(), cfg.torch_storage_dtype(), t_dtype_of(cfg)
    d = torch.zeros(2, 3, 4, dtype=cd if masked else sd)
    args = (d, torch.zeros(2, 3, 4, dtype=cd), *(torch.zeros(2, 3, 4, dtype=sd) for _ in range(3)))
    mu_next = None if masked else 0.625
    t = sd if masked else (td or sd)
    variant = hopper_kernels.kernel_variant(*args, t_dtype=t)
    assert variant in hopper_kernels.KERNEL_VARIANTS.values()
    with pytest.raises(ValueError, match="one CUDA device"):
        hopper_kernels._block_cuda(*args, 0.5, 0.7, 1.8, mu_l_next=mu_next, t_dtype=td)


def test_storage_f64_at_f32_resumes_bitwise(tmp_path):
    prob = make_completion_problem(np.random.default_rng(6), shape=SHAPE, rank=2, missing_ratio=0.0)
    d = torch.from_numpy(prob["y"])
    cfg = TriTDConfig(rank=2, max_iter=12, tol=0.0, lambda_l1=0.1, storage_dtype="float64")
    full = tritd_admm_checkpointed(d, cfg, str(tmp_path / "full"), every=6)
    tritd_admm_checkpointed(d, dataclasses.replace(cfg, max_iter=6), str(tmp_path / "crash"), every=6)
    path = str(tmp_path / "crash" / "step_000006.npz")
    with np.load(path) as f:
        assert f["o"].dtype == f["t"].dtype == np.float64 and f["a"].dtype == np.float32
    state = checkpoint.load_state(path, F32, storage_dtype=F64, device="cpu")
    assert all(getattr(state, f).dtype == F64 for f in ("o", "e", "y_l", "y_o", "t"))
    resumed = tritd_admm_checkpointed(d, cfg, str(tmp_path / "crash"), every=6)
    assert resumed.n_iters == 12
    for f in ("err_hist", "a", "b", "c", "o", "e"):
        torch.testing.assert_close(getattr(resumed, f), getattr(full, f), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_float32_stores_beside_float64_compute_are_held_to_one_rounding(masked):
    """`check_narrow_against_plain` holds float32 stores beside float64
    compute to one float32 rounding of the float64 value: the plain version
    passes against itself, and the same block computed in float32 (stored
    in float32 just the same) fails, with T' (unmasked) or without it
    (masked: D in float64, no T')."""
    rng = np.random.default_rng(21)
    shape = (6, 7, 8)
    d_dt = F64 if masked else F32
    args = [torch.from_numpy(3 * rng.standard_normal(shape)).to(dt) for dt in (d_dt, F64, F32, F32, F32)]
    mu_next, t_dt = (None, None) if masked else (0.625, F32)
    kw = dict(mu_l_next=mu_next, store_dtype=F32, t_dtype=t_dt)
    want = hopper_kernels._block_torch(*args, 0.5, 0.7, 1.8, compute_dtype=F64, **kw)
    assert hopper_kernels.kernel_variant(*args, t_dtype=t_dt or F32) == ("c64_d64_s32_t32" if masked
                                                                       else "c64_d32_s32_t32")
    ok = hopper_kernels.check_narrow_against_plain(args, want, want, mu_next)
    assert ok["flip_share"] == 0.0
    in_f32 = hopper_kernels._block_torch(*args, 0.5, 0.7, 1.8, compute_dtype=F32, **kw)
    with pytest.raises(AssertionError, match="rounded otherwise|D - O'"):
        hopper_kernels.check_narrow_against_plain(args, in_f32, want, mu_next)
