"""PyTorch port, the narrow dtypes float16, float8_e4m3fn and float8_e5m2
(beside bfloat16): `ops.narrow.narrow_cast`, the RHS contraction, the plain
elementwise block, single iterations, whole solves, interop and checkpoints,
held against the JAX package on the same numpy inputs (the JAX-drawn init
and state carried over through tritd_tpu_torch.interop).

Tolerances, with reasons:
  * narrow_cast: bitwise against `astype` (NaN in the same places, whatever
    its bits): it is the reference's rounding, nothing else.
  * rhs_mode with einsum_dtype: rtol 1e-5 (atol 1e-5 * max), as for bf16 in
    tests/test_torch_narrow.py: both sides multiply the same rounded
    operands exactly in float32 (a product of two 11-bit significands fits
    float32's 24) and sum in float32, in another order.
  * narrow tensors of the block and of one iteration: one rounding step of
    their dtype (`hopper_kernels.NARROW_ULP`: 2**-11 float16, 2**-4 e4m3fn,
    2**-3 e5m2), as rtol and times max|input| as atol: an f32 result an ulp
    apart can round to the neighbouring narrow value. Factors of one
    iteration rtol 1e-3 (the ridge solves on inputs one narrow step apart).
  * whole solves, 80 iterations: storage in any narrow dtype and the
    float16 einsum hold the first 10 err_hist entries to rtol 1e-3 and the
    final RRE within 0.03 of JAX's (the family bound of the reference's own
    bf16-vs-f32 test). A float8 einsum rounds the factors to 3 or 2
    significand bits every mode solve; a factor an f32 ulp away from JAX's
    flips its rounding by 6-12%, and the two trajectories part after 3 to 10
    iterations (seen: 4e-7 for three iterations, up to 1.3e-2 by the
    twelfth): the first 3 entries rtol 1e-4, the first 10 rtol 5e-2, the
    final RRE within 0.1 (seen: up to 0.06).
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from tritd_tpu.ops.pallas_kernels import _block_jnp  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers import init_state as j_init_state  # noqa: E402
from tritd_tpu.solvers import tritd_admm as j_tritd_admm  # noqa: E402
from tritd_tpu.solvers.admm import admm_iteration as j_admm_iteration  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu.solvers.admm import t_dtype_of as j_t_dtype_of  # noqa: E402
from tritd_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from tritd_tpu_torch import interop  # noqa: E402
from tritd_tpu_torch.data import make_completion_problem  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels, normal_eq  # noqa: E402
from tritd_tpu_torch.ops.hopper_kernels import NARROW_ULP, elementwise_block  # noqa: E402
from tritd_tpu_torch.ops.narrow import narrow_cast, round_to_odd_f32  # noqa: E402
from tritd_tpu_torch.solvers import (  # noqa: E402
    TriTDConfig,
    admm_iteration,
    init_state,
    t_dtype_of,
    tritd_admm,
    tritd_admm_checkpointed,
)
from tritd_tpu_torch.utils import checkpoint  # noqa: E402

jne = importlib.import_module("tritd_tpu.ops.normal_eq")

NEW = ("float16", "float8_e4m3fn", "float8_e5m2")
NARROW = ("bfloat16", *NEW)
SHAPE = (12, 10, 14)
R = 3
SCALARS = (0.5, 0.7, 1.8)
MU_NEXT = 0.625
# f64 inputs on which one rounding and two differ: 1 + half an ulp of the
# target + 2**-40 rounds up once; through float32 it first loses the 2**-40
# and then ties to even, down to 1 (and the same below -1)
F64_TIES = {"float16": 1 + 2.0**-11 + 2.0**-40, "float8_e4m3fn": 1 + 2.0**-4 + 2.0**-40,
            "float8_e5m2": 1 + 2.0**-3 + 2.0**-40}
# outputs at the ends of the float8 ranges and past them
EDGES = [0.0, -0.0, 448.0, 449.0, 464.0, 464.0001, 465.0, 480.0, 500.0, 57344.0, 60000.0, 61439.0, 61440.0,
         61441.0, 65504.0, 65520.0, 1e6, np.inf, -np.inf, np.nan, -448.0, -464.0, -465.0, -61440.0,
         2.0**-9, 2.0**-10, 3 * 2.0**-11, 2.0**-16, 2.0**-17, 3 * 2.0**-18, 2.0**-24, 2.0**-25, 3 * 2.0**-26,
         6.1e-5, 5.9e-5, 1e-30, -1e-30]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tdt(name):
    return getattr(torch, name)


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _same(got: torch.Tensor, want: np.ndarray, what: str = ""):
    """Bitwise equal, NaN to NaN whatever its bits."""
    g = interop_numpy(got)
    gf, wf = g.astype(np.float64), want.astype(np.float64)
    nan = np.isnan(wf)
    np.testing.assert_array_equal(np.isnan(gf), nan, err_msg=f"{what}: NaN in other places")
    np.testing.assert_array_equal(_bits(g)[~nan], _bits(np.asarray(want))[~nan], err_msg=what)


def interop_numpy(t: torch.Tensor) -> np.ndarray:
    """A narrow tensor as the numpy array JAX would hand over (ml_dtypes)."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16):
        name = str(t.dtype).removeprefix("torch.")
        bits = np.uint8 if t.element_size() == 1 else np.uint16
        view = torch.uint8 if t.element_size() == 1 else torch.int16
        return t.view(view).numpy().view(bits).view(getattr(ml_dtypes, name))
    return t.numpy()


def _jax_cast(x: np.ndarray, name: str) -> np.ndarray:
    with jax.enable_x64(x.dtype == np.float64):
        return np.asarray(jnp.asarray(x).astype(getattr(jnp, name)))


# --- narrow_cast --------------------------------------------------------------


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_every_float8_pattern_round_trips_as_jax_rounds_it(name):
    patterns = np.arange(256, dtype=np.uint8).view(getattr(ml_dtypes, name))
    for wide in (np.float32, np.float64):
        x = patterns.astype(wide)
        got = narrow_cast(torch.from_numpy(x), _tdt(name))
        _same(got, _jax_cast(x, name), f"{name} from {np.dtype(wide).name}")
        finite = np.isfinite(x)
        np.testing.assert_array_equal(interop_numpy(got)[finite].astype(wide), x[finite])


@pytest.mark.parametrize("name", NEW)
def test_narrow_cast_of_a_float32_sweep_is_jax_astype(name):
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(np.log(1e-6), np.log(6e4), 200_000)) * rng.choice([-1.0, 1.0], 200_000)
    x = np.concatenate([x, EDGES]).astype(np.float32)
    _same(narrow_cast(torch.from_numpy(x), _tdt(name)), _jax_cast(x, name), name)


@pytest.mark.parametrize("name", NEW)
def test_narrow_cast_rounds_once_from_float64(name):
    rng = np.random.default_rng(1)
    x = np.exp(rng.uniform(np.log(1e-9), np.log(1e5), 100_000)) * rng.choice([-1.0, 1.0], 100_000)
    # values a hair above and below each tie of the target's grid
    grid = _jax_cast(np.linspace(-400.0, 400.0, 4001), name).astype(np.float64)
    mids = (grid[1:] + grid[:-1]) / 2
    ties = np.concatenate([mids, mids * (1 + 2.0**-40), mids * (1 - 2.0**-40)])
    x = np.concatenate([x, ties, EDGES, [F64_TIES[name], -F64_TIES[name], 3.5e38, 1e300, -1e300, 1e-300]])
    want = _jax_cast(x, name)
    got = narrow_cast(torch.from_numpy(x), _tdt(name))
    _same(got, want, name)
    tie = narrow_cast(torch.tensor([F64_TIES[name]], dtype=torch.float64), _tdt(name))
    assert float(tie.double()) > 1.0  # rounded up once
    assert float(torch.tensor([F64_TIES[name]], dtype=torch.float64).to(_tdt(name)).double()) == 1.0  # torch: twice


def test_bfloat16_from_float64_rounds_through_float32_in_both_packages():
    x = np.array([1 + 2.0**-8 + 2.0**-40, -(1 + 2.0**-8 + 2.0**-40), 3.0 + 2.0**-30])
    got = narrow_cast(torch.from_numpy(x), torch.bfloat16)
    want = _jax_cast(x, "bfloat16")
    _same(got, want, "bfloat16")
    assert float(got[0]) == 1.0


def test_float8_e4m3fn_overflow_is_nan_where_torch_saturates():
    x = torch.tensor([448.0, 464.0, 464.5, 480.0, 1e4, float("inf"), -500.0, float("-inf")])
    got = narrow_cast(x, torch.float8_e4m3fn).float()
    assert got[:2].tolist() == [448.0, 448.0] and got[2:].isnan().all()
    assert not x.to(torch.float8_e4m3fn).float().isnan().any()  # what a plain .to() would give
    e5 = narrow_cast(torch.tensor([57344.0, 61439.0, 61440.0, -1e5]), torch.float8_e5m2).float()
    assert e5.tolist() == [57344.0, 57344.0, float("inf"), float("-inf")]


def test_round_to_odd_sets_the_sticky_bit():
    x = torch.tensor([1.0, 1 + 2.0**-30, -(1 + 2.0**-30), 1 - 2.0**-30, 1e-300, -1e-300, 1e300, float("nan")],
                     dtype=torch.float64)
    y = round_to_odd_f32(x)
    bits = y.view(torch.int32)
    assert y[0] == 1.0 and (bits[1:7] & 1).all()
    assert y[1] > 1.0 and y[2] < -1.0 and y[3] < 1.0  # toward zero, then one ulp out on the odd side
    assert y[4] > 0 and y[5] < 0 and float(y[4]) < 1e-44
    assert y[6] == torch.finfo(torch.float32).max and y[7].isnan()


# --- rhs_mode -----------------------------------------------------------------


@pytest.mark.parametrize("variant", ["hadamard", "full"])
@pytest.mark.parametrize("mode", [1, 2, 3])
@pytest.mark.parametrize("x_narrow", [False, True], ids=["x_f32", "x_narrow"])
@pytest.mark.parametrize("name", NEW)
def test_rhs_mode_einsum_dtype_matches_jax(name, mode, variant, x_narrow):
    rng = np.random.default_rng(mode)
    x = rng.standard_normal(SHAPE).astype(np.float32) * 10
    if x_narrow:
        x = _jax_cast(x, name)
    cores = [rng.standard_normal(s).astype(np.float32) for s in ((12, R, R), (R, 10, R), (R, R, 14))]
    want = np.asarray(jne.rhs_mode(mode, jnp.asarray(x), *map(jnp.asarray, cores), variant=variant,
                                   einsum_dtype=getattr(jnp, name)))
    xt = interop.tensor_from_numpy(x)
    got = normal_eq.rhs_mode(mode, xt, *map(torch.from_numpy, cores), variant=variant, einsum_dtype=_tdt(name))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    full = normal_eq.rhs_mode(mode, xt.float(), *map(torch.from_numpy, cores), variant=variant)
    assert not torch.equal(full, got)  # the operands really were rounded


@pytest.mark.parametrize("name", NEW)
def test_rhs_mode_einsum_dtype_keeps_f64_factors(name):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(SHAPE)
    cores = [rng.standard_normal(s) for s in ((12, R, R), (R, 10, R), (R, R, 14))]
    with jax.enable_x64(True):
        want = np.asarray(jne.rhs_mode(2, jnp.asarray(x), *map(jnp.asarray, cores), einsum_dtype=getattr(jnp, name)))
    got = normal_eq.rhs_mode(2, torch.from_numpy(x), *map(torch.from_numpy, cores), einsum_dtype=_tdt(name))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# --- the plain elementwise block ----------------------------------------------


def _block_cases():
    """(compute, D, storage, T' or None) of the new variants: per dtype X
    storage X, masked storage X, einsum X alone; and the ordered pairs of
    two different narrow dtypes (storage S, einsum T)."""
    cases = {}
    for cd in ("float32", "float64"):
        for x in NEW:
            cases[f"{cd}-storage-{x}"] = (cd, x, x, x)
            cases[f"{cd}-masked-{x}"] = (cd, cd, x, None)
            cases[f"{cd}-einsum-{x}"] = (cd, cd, cd, x)
        for s in NARROW:
            for t in NARROW:
                if s != t:
                    cases[f"{cd}-{s}+{t}"] = (cd, s, s, t)
    return cases


BLOCK_CASES = _block_cases()


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_plain_narrow_block_matches_jax(case):
    cd, d_dt, s_dt, t_dt = BLOCK_CASES[case]
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((17, 23, 31)) * 3 for _ in range(5)]
    dtypes = (d_dt, cd, s_dt, s_dt, s_dt)
    with jax.enable_x64(cd == "float64"):
        j_in = [jnp.asarray(a.astype(cd)).astype(getattr(jnp, dt)) for a, dt in zip(arrays, dtypes)]
        narrow = s_dt != cd
        o, e, y_l, y_o, nl, no = _block_jnp(*j_in, *SCALARS, compute_dtype=getattr(jnp, cd) if narrow else None,
                                            store_dtype=getattr(jnp, s_dt) if narrow else None)
        want = [np.asarray(v) for v in (o, e, y_l, y_o)]
        t_want = None
        if t_dt is not None:
            # T' as the reference's solver forms it: from D and the STORED O', Y_L'
            c = getattr(jnp, cd)
            t_wide = j_in[0].astype(c) - o.astype(c) + y_l.astype(c) / c(MU_NEXT)
            t_want = np.asarray(t_wide.astype(getattr(jnp, t_dt)))
        nl, no = float(nl), float(no)
    t_in = [interop.tensor_from_numpy(np.asarray(a)) for a in j_in]
    got = elementwise_block(*t_in, *SCALARS, mu_l_next=None if t_dt is None else MU_NEXT,
                            t_dtype=None if t_dt is None else _tdt(t_dt))
    scale = max(np.abs(a).max() for a in arrays)
    for name, g, w in zip(("o", "e", "y_l", "y_o", "t"), (*got[:4], got[6]), (*want, t_want)):
        if w is None:
            assert g is None
            continue
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, name
        ulp = NARROW_ULP.get(g.dtype, 1e-6 if cd == "float32" else 1e-12)
        np.testing.assert_allclose(g.double().numpy(), w.astype(np.float64), rtol=ulp, atol=ulp * scale,
                                   err_msg=f"{case} {name}")
    for g, w in zip(got[4:6], (nl, no)):
        assert g.dtype == _tdt(cd)
        np.testing.assert_allclose(float(g), w, rtol=1e-5)


@pytest.mark.parametrize("name", NEW)
def test_narrow_check_accepts_the_plain_version_and_counts_nan_as_equal(name):
    """check_narrow_against_plain on each new dtype: the plain outputs pass
    against themselves, NaN in both places included; a T' built from the
    unrounded O' and Y_L' fails."""
    x = _tdt(name)
    rng = np.random.default_rng(12)
    raw = [torch.from_numpy(rng.standard_normal((24, 20, 28)).astype(np.float32) * 3) for _ in range(5)]
    raw[0][0, 0, :4] = torch.tensor([500.0, -500.0, 70000.0, float("inf")])  # NaN or inf once narrowed
    args = [narrow_cast(raw[0], x), raw[1], *(narrow_cast(r, x) for r in raw[2:])]
    want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=MU_NEXT, compute_dtype=torch.float32,
                                       store_dtype=x, t_dtype=x)
    assert want[0].float().isnan().any() or want[0].float().isinf().any()
    ok = hopper_kernels.check_narrow_against_plain(args, want, want, MU_NEXT)
    assert ok["flip_share"] == 0.0 and ok["max_abs_err"] == 0.0
    o, _e, y_l, *_ = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=MU_NEXT, compute_dtype=torch.float32)
    unrounded = narrow_cast(args[0].float() - o + y_l / MU_NEXT, x)
    with pytest.raises(AssertionError, match="from the stored O' and Y_L'"):
        hopper_kernels.check_narrow_against_plain(args, (*want[:6], unrounded), want, MU_NEXT)


@pytest.mark.parametrize("variant", sorted(v for v in hopper_kernels.KERNEL_VARIANTS.values() if v not in ("f32", "f64")))
def test_edge_inputs_make_each_store_the_rounding_of_its_value(variant):
    """The card's conversion-edge check (`hopper_kernels.edge_args`) rests on
    the block being exact on those inputs: O' and E' are the edge values
    themselves, rounded by narrow_cast, and Y_L' half of them (where they
    are finite)."""
    key = next(k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    cd, d_dt, s_dt, t_dt = key
    masked = d_dt == cd and s_dt != cd
    values = torch.tensor(hopper_kernels.EDGE_VALUES, dtype=torch.float64).to(cd)
    args = hopper_kernels.edge_args(hopper_kernels.EDGE_VALUES, key, "cpu")
    got = elementwise_block(*args, *hopper_kernels.EDGE_SCALARS,
                            mu_l_next=None if masked else hopper_kernels.EDGE_MU_NEXT, t_dtype=t_dt)
    finite = values.isfinite()  # at +-inf the residual D - L - O' is inf - inf
    for i, want in ((0, values), (1, values), (2, values / 2)):
        assert not hopper_kernels._differ(got[i][finite], narrow_cast(want, s_dt)[finite]).any(), i
    assert hopper_kernels.check_stores_bitwise(got, got) == sum(got[i].numel() for i in (0, 1, 2, 3)) + (
        0 if masked else got[6].numel())


def test_narrow_check_lets_t_carry_a_flipped_store():
    """An O' whose e5m2 rounding flipped to the neighbouring value (as an ulp
    of float32 difference can flip it on the card) moves T' = D - O' +
    Y_L'/mu by a whole e5m2 step, which is far more than a bf16 step of T'
    itself: the check allows T' what O' and Y_L' differ by, and no more."""
    rng = np.random.default_rng(13)
    raw = [torch.from_numpy(rng.standard_normal((30, 40)).astype(np.float32) * 3) for _ in range(5)]
    s_dt, t_dt = torch.float8_e5m2, torch.bfloat16
    args = [narrow_cast(raw[0], s_dt), raw[1], *(narrow_cast(r, s_dt) for r in raw[2:])]
    want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=MU_NEXT, compute_dtype=torch.float32,
                                       store_dtype=s_dt, t_dtype=t_dt)
    o = want[0].clone()
    # an O' well inside the inputs' range, where one e5m2 step is within
    # the check's own tolerance for O'
    size = want[0].float().abs().flatten()
    k = int(torch.nonzero((size > 2) & (size < 4))[0])
    up = o.view(torch.uint8).flatten()
    up[k] += 1  # the next e5m2 value away from zero
    t = narrow_cast(args[0].float() - o.float() + want[2].float() / MU_NEXT, t_dt)
    got = (o, *want[1:6], t)
    assert float((t.float() - want[6].float()).abs().max()) > NARROW_ULP[t_dt] * 100
    hopper_kernels.check_narrow_against_plain(args, got, want, MU_NEXT)
    bad = t.clone()
    bad.view(torch.int16).flatten()[k + 1] += 3  # three bf16 steps off where nothing flipped
    with pytest.raises(AssertionError, match="t: "):
        hopper_kernels.check_narrow_against_plain(args, (o, *want[1:6], bad), want, MU_NEXT)


# --- configuration, state, one iteration --------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("einsum", [None, *NARROW])
@pytest.mark.parametrize("storage", [None, *NARROW])
def test_t_dtype_and_init_state_match_jax(storage, einsum, dtype):
    cfg = TriTDConfig(rank=R, storage_dtype=storage, einsum_dtype=einsum, dtype=dtype)
    want = j_t_dtype_of(JConfig(**dataclasses.asdict(cfg)))
    got = t_dtype_of(cfg)
    assert (got is None and want is None) or str(got).removeprefix("torch.") == str(want)
    d = torch.full(SHAPE, 500.0, dtype=cfg.torch_dtype())
    init = [np.ones(s) for s in ((12, R, R), (R, 10, R), (R, R, 14))]
    state = init_state(d, cfg, init)
    assert state.o.dtype == state.y_o.dtype == cfg.torch_storage_dtype()
    assert state.t.dtype == (got or cfg.torch_dtype())
    assert state.a.dtype == state.err_hist.dtype == cfg.torch_dtype()
    # T_0 = D in the carried dtype, rounded as JAX rounds it (500 is NaN in e4m3fn)
    with jax.enable_x64(dtype == "float64"):
        j_state = j_init_state(jnp.asarray(d.numpy()), JConfig(**dataclasses.asdict(cfg)), jax.random.PRNGKey(0))
        _same(state.t, np.asarray(j_state.t), "t")


def test_every_configuration_routes_to_its_own_kernel_variant():
    """Each (dtype, storage_dtype, einsum_dtype, masked) hands the block
    tensors that one variant of the kernel takes (on CPU tensors the CUDA
    wrapper gets past the choice of variant and stops at the device), and
    the configurations reach all 50 variants."""
    reached = set()
    for dtype in ("float32", "float64"):
        for storage in (None, *NARROW):
            for einsum in (None, *NARROW):
                for masked in (False, True):
                    cfg = TriTDConfig(rank=R, dtype=dtype, storage_dtype=storage, einsum_dtype=einsum, masked=masked)
                    cd, sd, td = cfg.torch_dtype(), cfg.torch_storage_dtype(), t_dtype_of(cfg)
                    # what admm_iteration passes: the imputed D in the compute
                    # dtype when masked, else D as stored; no T' when masked
                    d = torch.zeros(2, 3, 4, dtype=cd if masked else sd)
                    args = (d, torch.zeros(2, 3, 4, dtype=cd), *(torch.zeros(2, 3, 4, dtype=sd) for _ in range(3)))
                    mu_next = None if masked else MU_NEXT
                    with pytest.raises(ValueError, match="one CUDA device"):
                        hopper_kernels._block_cuda(*args, *SCALARS, mu_l_next=mu_next, t_dtype=td)
                    t = (td or sd) if mu_next is not None else sd
                    reached.add(hopper_kernels.kernel_variant(*args, t_dtype=t))
    assert reached == set(hopper_kernels.KERNEL_VARIANTS.values())


@pytest.mark.parametrize("name", ["int8", "float8_e4m3fnuz", "float8_e5m2fnuz", "float64"])
def test_other_dtype_names_raise(name):
    for field in ("storage_dtype", "einsum_dtype"):
        with pytest.raises(NotImplementedError, match="takes None or one of"):
            tritd_admm(torch.zeros(SHAPE), TriTDConfig(rank=R, **{field: name}))


def _problem(seed=0, missing=0.0):
    """(truth, truth + 5% of +-5 spikes); the truth is low-TriTD-rank with
    unit RMS."""
    rng = np.random.default_rng(seed)
    n1, n2, n3 = SHAPE
    a, b, c = (rng.standard_normal(s) for s in ((n1, 2, 2), (2, n2, 2), (2, 2, n3)))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = x / np.sqrt(np.mean(x**2))
    spikes = (rng.random(SHAPE) < 0.05) * np.where(rng.random(SHAPE) < 0.5, 5.0, -5.0)
    return x.astype(np.float32), (x + spikes).astype(np.float32)


ITERATION_FIELDS = {
    "s_f16": dict(storage_dtype="float16"), "s_e4m3": dict(storage_dtype="float8_e4m3fn"),
    "s_e5m2": dict(storage_dtype="float8_e5m2"), "e_f16": dict(einsum_dtype="float16"),
    "e_e4m3": dict(einsum_dtype="float8_e4m3fn"), "e_e5m2": dict(einsum_dtype="float8_e5m2"),
    "s_e5m2+e_f16": dict(storage_dtype="float8_e5m2", einsum_dtype="float16"),
}
# masked mode with float8 storage raises in the reference (see
# test_masked_float8_storage_runs_where_the_reference_raises)
ITERATION_CASES = [(name, masked) for name, fields in ITERATION_FIELDS.items() for masked in (False, True)
                   if not (masked and fields.get("storage_dtype", "").startswith("float8"))]


@pytest.mark.parametrize("case,masked", ITERATION_CASES,
                         ids=[f"{name}-{'masked' if m else 'unmasked'}" for name, m in ITERATION_CASES])
def test_admm_iteration_from_jax_narrow_state(case, masked):
    """One iteration from the reference's own narrow state (narrow fields
    carried over bit for bit) lands on its next state within one rounding
    step of each field's dtype."""
    _x, spiked = _problem(1)
    mask = np.random.default_rng(2).random(SHAPE) > 0.3
    y = np.where(mask, spiked, 0.0).astype(np.float32)
    cfg = TriTDConfig(rank=R, masked=masked, lambda_l1=0.1, **ITERATION_FIELDS[case])
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jd = jnp.asarray(y, jnp.float32)
    jmask = jnp.asarray(mask) if masked else None
    s = j_init_state(jd, jcfg, jax.random.PRNGKey(3))
    norm_d = np.linalg.norm(y.astype(np.float64)).astype(np.float32)
    jd = jd.astype(jcfg.jnp_storage_dtype())
    for _ in range(3):
        s = j_admm_iteration(jd, s, jcfg, mask=jmask, norm_d=jnp.asarray(norm_d))
    start = {f: np.asarray(getattr(s, f)) for f in s._fields}
    s = j_admm_iteration(jd, s, jcfg, mask=jmask, norm_d=jnp.asarray(norm_d))
    want = {f: np.asarray(getattr(s, f)) for f in s._fields}
    state = interop.state_from_numpy(start)
    assert state.k == 3 and state.o.dtype == cfg.torch_storage_dtype()
    d = interop.tensor_from_numpy(np.asarray(jd))
    got = admm_iteration(d, state, cfg, mask=torch.from_numpy(mask) if masked else None,
                         norm_d=torch.tensor(norm_d))
    assert got.mu_l == want["mu_l"] and got.k == 4
    scale = np.abs(y).max()
    for f in ("o", "e", "y_l", "y_o", "t"):
        g = getattr(got, f)
        assert str(g.dtype).removeprefix("torch.") == want[f].dtype.name, f
        ulp = NARROW_ULP.get(g.dtype, 1e-5)
        np.testing.assert_allclose(g.double().numpy(), want[f].astype(np.float64), rtol=ulp, atol=ulp * scale,
                                   err_msg=f)
    for f in ("a", "b", "c"):
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f], rtol=1e-3,
                                   atol=1e-4 * np.abs(want[f]).max(), err_msg=f)
    np.testing.assert_allclose(got.err_hist[:4].numpy(), want["err_hist"][:4], rtol=1e-4)


# --- whole solves ------------------------------------------------------------

SOLVES = {
    "storage_f16": dict(storage_dtype="float16"),
    "storage_e4m3": dict(storage_dtype="float8_e4m3fn"),
    "storage_e5m2": dict(storage_dtype="float8_e5m2"),
    "einsum_f16": dict(einsum_dtype="float16"),
    "einsum_e4m3": dict(einsum_dtype="float8_e4m3fn"),
    "einsum_e5m2": dict(einsum_dtype="float8_e5m2"),
    "both_f16": dict(storage_dtype="float16", einsum_dtype="float16"),
    "storage_f16_einsum_bf16": dict(storage_dtype="float16", einsum_dtype="bfloat16"),
    "storage_bf16_einsum_e4m3": dict(storage_dtype="bfloat16", einsum_dtype="float8_e4m3fn"),
    "masked_f16": dict(storage_dtype="float16", masked=True, lambda_l1=1.8),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(SOLVES))
def test_narrow_solve_matches_jax(case, dtype):
    fields = SOLVES[case]
    masked = fields.get("masked", False)
    if masked:
        prob = make_completion_problem(np.random.default_rng(0), shape=SHAPE, rank=2, missing_ratio=0.3)
        x, d, mask = prob["x"], prob["y"], prob["mask"]
    else:
        (x, d), mask = _problem(), None
    cfg = TriTDConfig(**{"rank": 2, "max_iter": 80, "tol": 1e-7, "lambda_l1": 0.1, "dtype": dtype, **fields})
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, 2, jdt)]
        jres = j_tritd_admm(jnp.asarray(d, jdt), JConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0),
                            mask=jnp.asarray(mask) if masked else None, origin=jnp.asarray(x, jdt))
        want, jn = np.asarray(jres.err_hist), int(jres.n_iters)
        j_rre = float(np.asarray(jres.rre_hist)[jn - 1])
    res = tritd_admm(torch.from_numpy(d).to(_tdt(dtype)), cfg, mask=torch.from_numpy(mask) if masked else None,
                     origin=torch.from_numpy(x), init=init)
    assert res.o.dtype == res.e.dtype == res.a.dtype == _tdt(dtype)  # back in cfg.dtype
    n = res.n_iters
    got = res.err_hist.numpy()
    assert np.isfinite(got[:n]).all() and n > 10 and jn > 10
    rre = float(res.rre_hist[n - 1])
    if fields.get("einsum_dtype", "").startswith("float8"):
        np.testing.assert_allclose(got[:3], want[:3], rtol=1e-4)
        np.testing.assert_allclose(got[:10], want[:10], rtol=5e-2)
        assert abs(rre - j_rre) < 0.1, (rre, j_rre)
    else:
        np.testing.assert_allclose(got[:10], want[:10], rtol=1e-3)
        assert abs(rre - j_rre) < 0.03, (rre, j_rre)


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_masked_float8_storage_runs_where_the_reference_raises(name):
    """The reference's masked imputation (`jnp.where(mask, d, l_prev + o)`,
    tritd_tpu/solvers/admm.py) meets a float8 D and a float32 estimate, and
    JAX refuses to promote float8 implicitly: its masked float8 solve
    raises. The port widens D to the compute dtype first, as the reference
    means to (its float16 and bf16 runs do that by promotion), and runs
    through the masked float8 kernel variant: err_hist finite and falling."""
    prob = make_completion_problem(np.random.default_rng(0), shape=SHAPE, rank=2, missing_ratio=0.3)
    x, d, mask = prob["x"], prob["y"], prob["mask"]
    cfg = TriTDConfig(rank=2, max_iter=40, tol=0.0, masked=True, storage_dtype=name)
    with pytest.raises(ValueError, match="implicit dtype promotion"):  # JAX's TypePromotionError
        j_tritd_admm(jnp.asarray(d), JConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0),
                     mask=jnp.asarray(mask))
    init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, 2, jnp.float32)]
    res = tritd_admm(torch.from_numpy(d), cfg, mask=torch.from_numpy(mask), origin=torch.from_numpy(x), init=init)
    err = res.err_hist.numpy()
    assert res.n_iters == 40 and np.isfinite(err).all() and err[-1] < err[0]
    assert float(res.rre_hist[-1]) < float(res.rre_hist[0])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("field", ["storage_dtype", "einsum_dtype"])
def test_e4m3fn_past_its_range_is_nan_in_both_packages(field, dtype):
    """One entry of 500 in D: float8_e4m3fn has no value for it, JAX stores
    NaN, and from the first iteration on both err_hists are NaN."""
    _x, d = _problem(5)
    d[3, 4, 5] = 500.0
    cfg = TriTDConfig(rank=2, max_iter=6, tol=1e-7, lambda_l1=0.1, dtype=dtype, **{field: "float8_e4m3fn"})
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, 2, jdt)]
        jres = j_tritd_admm(jnp.asarray(d, jdt), JConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0))
        want = np.asarray(jres.err_hist)
    res = tritd_admm(torch.from_numpy(d).to(_tdt(dtype)), cfg, init=init)
    assert np.isnan(want).all() and res.err_hist.isnan().all()
    assert res.n_iters == int(jres.n_iters) == 6  # a NaN never meets the stop rule


@pytest.mark.parametrize("einsum", ["float8_e4m3fn", "float8_e5m2"])
def test_float8_einsum_diverges_on_a_highway_crop_in_both_packages(einsum):
    """A 60x80x75 crop of the highway stand-in (its values well inside both
    formats) under VIDEO_TRITD: a float8 einsum passes the format's range
    within three iterations, in the reference and in the port, and both
    err_hists stay NaN from there on. The first entry agrees."""
    from tritd_tpu_torch.data import load_dataset
    from tritd_tpu_torch.utils.config import VIDEO_TRITD

    x = np.ascontiguousarray(load_dataset("highway")[0][:60, :80, :75]).astype(np.float32)
    cfg = dataclasses.replace(VIDEO_TRITD, max_iter=8, einsum_dtype=einsum)
    init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), x.shape, cfg.rank, jnp.float32)]
    want = np.asarray(j_tritd_admm(jnp.asarray(x), JConfig(**dataclasses.asdict(cfg)),
                                   key=jax.random.PRNGKey(0)).err_hist)
    got = tritd_admm(torch.from_numpy(x), cfg, init=init).err_hist.numpy()
    for err in (want, got):
        assert np.isfinite(err[0]) and np.isnan(err[3:]).all(), err
    # a float8 einsum rounds the factors (module docstring): 1.7e-4 apart seen
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)


# --- interop and checkpoints --------------------------------------------------


@pytest.mark.parametrize("name", NARROW)
def test_interop_carries_narrow_jax_arrays_bitwise(name):
    x = np.random.default_rng(4).standard_normal((5, 6)).astype(np.float32) * 100
    arr = np.asarray(jnp.asarray(x).astype(getattr(jnp, name)))
    t = interop.tensor_from_numpy(arr)
    assert t.dtype == _tdt(name) and t.shape == arr.shape
    _same(t, arr, name)


def _narrow_state_fields(state):
    return {f: getattr(state, f) for f in ("o", "e", "y_l", "y_o", "t")}


@pytest.mark.parametrize("name", NEW)
def test_checkpoint_round_trips_and_resumes_bitwise(tmp_path, name):
    _x, d = _problem(6)
    d = torch.from_numpy(d)
    cfg = TriTDConfig(rank=2, max_iter=12, tol=0.0, lambda_l1=0.1, storage_dtype=name)
    full = tritd_admm_checkpointed(d, cfg, str(tmp_path / "full"), every=6)
    short = dataclasses.replace(cfg, max_iter=6)
    tritd_admm_checkpointed(d, short, str(tmp_path / "crash"), every=6)
    path = str(tmp_path / "crash" / "step_000006.npz")
    with np.load(path) as f:
        assert f["o"].dtype == (np.float16 if name == "float16" else np.float32)
    state = checkpoint.load_state(path, torch.float32, storage_dtype=_tdt(name))
    for f, t in _narrow_state_fields(state).items():
        assert t.dtype == _tdt(name), f
    again = str(tmp_path / "again.npz")
    checkpoint.save_state(again, state)
    with np.load(path) as f, np.load(again) as g:
        for key in f.files:
            np.testing.assert_array_equal(f[key], g[key], err_msg=key)
    resumed = tritd_admm_checkpointed(d, cfg, str(tmp_path / "crash"), every=6)
    assert resumed.n_iters == 12
    for f in ("err_hist", "a", "b", "c", "o", "e"):
        torch.testing.assert_close(getattr(resumed, f), getattr(full, f), rtol=0, atol=0, equal_nan=True)


def test_float16_port_checkpoint_loads_in_the_reference(tmp_path):
    _x, d = _problem(7)
    cfg = TriTDConfig(rank=2, max_iter=5, tol=0.0, lambda_l1=0.1, storage_dtype="float16")
    tritd_admm_checkpointed(torch.from_numpy(d), cfg, str(tmp_path), every=5)
    path = str(tmp_path / "step_000005.npz")
    port = checkpoint.load_state(path, torch.float32, storage_dtype=torch.float16)
    ref = jcheckpoint.load_state(path, dtype=jnp.float32, storage_dtype=jnp.float16)
    assert int(ref.k) == port.k == 5
    for f, t in _narrow_state_fields(port).items():
        arr = np.asarray(getattr(ref, f))
        assert arr.dtype == np.float16, f
        np.testing.assert_array_equal(arr.view(np.uint16), t.numpy().view(np.uint16), err_msg=f)


@pytest.mark.parametrize("name", NARROW)
def test_rebuilt_t_from_a_float64_d_matches_the_reference(tmp_path, name):
    """A checkpoint without t, loaded with a float64 d: the port rebuilds t
    as the reference's load_state does, d rounded once into O's dtype."""
    _x, d = _problem(8)
    cfg = TriTDConfig(rank=2, max_iter=4, tol=0.0, lambda_l1=0.1, storage_dtype=name)
    tritd_admm_checkpointed(torch.from_numpy(d), cfg, str(tmp_path), every=4)
    with np.load(tmp_path / "step_000004.npz") as f:
        arrays = {k: f[k] for k in f.files if k != "t"}
    path = str(tmp_path / "no_t.npz")
    np.savez(path, **arrays)
    d64 = d.astype(np.float64)
    # values that a second rounding through float32 moves in float16, e4m3fn and e5m2
    d64.flat[:3] = [1 + 2**-11 + 2**-40, 1 + 2**-4 + 2**-40, 1 + 2**-3 + 2**-40]
    port = checkpoint.load_state(path, torch.float32, d=d64, storage_dtype=_tdt(name))
    assert port.t.dtype == _tdt(name)
    jdt = getattr(jnp, name)
    if name in NEW[1:]:
        # the reference's rebuild mixes float8 and float32 operands, which
        # JAX refuses to promote: its formula with the widening written out,
        # d narrowed by jnp's astype (ml_dtypes' numpy cast from float64
        # goes through float32)
        with pytest.raises(ValueError, match="implicit dtype promotion"):
            jcheckpoint.load_state(path, dtype=jnp.float32, d=d64, storage_dtype=jdt)
        with np.load(path) as f:
            o, y_l, mu_l = (jnp.asarray(f[k]) for k in ("o", "y_l", "mu_l"))
        dn = jnp.asarray(_jax_cast(d64, name))  # jnp's astype: one rounding from float64
        diff = (dn.astype(jnp.float32) - o.astype(jdt).astype(jnp.float32)).astype(jdt)
        want = (diff.astype(jnp.float32) + y_l.astype(jdt).astype(jnp.float32) / mu_l).astype(jdt)
    else:
        want = jcheckpoint.load_state(path, dtype=jnp.float32, d=d64, storage_dtype=jdt).t
    _same(port.t, np.asarray(want), "t")


def test_the_reference_checkpoint_mangles_float8_where_the_port_does_not(tmp_path):
    """The reference's `_np_savable` (tritd_tpu/utils/checkpoint.py:23-34)
    takes an ml_dtypes float8_e4m3fn array for a raw void and views it as
    bf16: a 3x4 array is saved as a 3x2 float32 of other numbers. An e5m2
    array it saves as it is, which np.load cannot rebuild. The port widens
    both to float32 (exact) and narrows them again on load: an open fault of
    the reference, ROADMAP.md section 3."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    e4 = a.astype(ml_dtypes.float8_e4m3fn)
    mangled = jcheckpoint._np_savable(e4)
    assert mangled.shape == (3, 2) and mangled.dtype == np.float32
    assert not np.array_equal(mangled, a[:, :2])
    e5 = jcheckpoint._np_savable(a.astype(ml_dtypes.float8_e5m2))
    np.savez(tmp_path / "ref_e5m2.npz", x=e5)
    with np.load(tmp_path / "ref_e5m2.npz") as f, pytest.raises(ValueError, match="descr"):
        f["x"]
    for name in ("float8_e4m3fn", "float8_e5m2"):
        saved = checkpoint._np_savable(narrow_cast(torch.from_numpy(a), _tdt(name)))
        assert saved.shape == (3, 4) and saved.dtype == np.float32
        np.testing.assert_array_equal(saved, a.astype(getattr(ml_dtypes, name)).astype(np.float32))
