"""PyTorch port, `tritd_tpu_torch.ops.elementwise_block`: the reference's
signature and six outputs (`tritd_tpu/ops/pallas_kernels.py:160-188`), a
twin of `tests/test_pallas.py` held against `tritd_tpu.ops.elementwise_block`
on the same numpy inputs, through both of the reference's routes where it
has two (the jnp fusion, and the Pallas kernel in interpret mode for a
float32 or float64 call without dtypes).

Tolerances: float32 rtol 1e-6 (atol 1e-6) on the tensors and 1e-5 on the
two sums, as `tests/test_pallas.py` holds the reference's own routes;
float64 rtol 1e-12. A narrow store is held to one step of its format
(`hopper_kernels.NARROW_ULP`, with atol of that step times max |input|): an
ulp of float32 arithmetic in another order can flip its rounding. Mixed
input dtypes without `compute_dtype`: the reference promotes operation by
operation (Y_L / mu_L of a float32 Y_L is rounded to float32 before it
meets float64 D), the port casts all five inputs to the promoted dtype
first, so a float32/float64 mix is held at float32's rtol 1e-6. The card's
routes (one launch when the dtypes name a variant, else the pure variant
and `narrow_cast`) are chosen by `hopper_kernels.flat_variant`, held here;
their launches are checked on the card by `chip_smoke.py` phase 20."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from tritd_tpu.ops import elementwise_block as j_block  # noqa: E402
from tritd_tpu_torch import ops  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops.hopper_kernels import NARROW_ULP, flat_variant  # noqa: E402

SHAPES = [(17, 23, 31), (8, 128, 4), (5, 7, 11)]
SCALARS = (0.5, 0.7, 1.8)
TOL = {np.float32: (1e-6, 1e-5), np.float64: (1e-12, 1e-12)}
F32, F64, BF16, F16 = torch.float32, torch.float64, torch.bfloat16, torch.float16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, dtypes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dt) for dt in dtypes]


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included) as a CPU tensor."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(BF16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == BF16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _reference(arrays, x64, **kw):
    with jax.enable_x64(x64):
        out = j_block(*map(jnp.asarray, arrays), *SCALARS, **kw)
        return [np.asarray(v) for v in out]


def _held(got, want, rtol, sum_rtol, scale):
    assert len(got) == 6
    for g, w in zip(got[:4], want[:4]):
        g = _numpy(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        ulp = NARROW_ULP.get(getattr(torch, str(w.dtype)))
        tol = rtol if ulp is None else ulp
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=tol, atol=tol * scale)
    for g, w in zip(got[4:], want[4:]):
        assert g.dim() == 0 and _numpy(g).dtype == w.dtype
        np.testing.assert_allclose(float(g), float(w), rtol=sum_rtol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas_interpret"])
def test_same_dtype_matches_both_reference_routes(shape, dtype, use_pallas):
    arrays = _inputs(shape, [dtype] * 5)
    want = _reference(arrays, dtype == np.float64, use_pallas=use_pallas, interpret=use_pallas)
    got = ops.elementwise_block(*map(_torch, arrays), *SCALARS, use_pallas=use_pallas, interpret=use_pallas)
    _held(got, want, *TOL[dtype], 1.0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("store", [BF16, F16], ids=["bf16", "f16"])
def test_narrow_storage_at_float32_compute(shape, store):
    """The solver's narrow-storage call: D and L in float32, E, Y_L, Y_O in
    the storage dtype, `compute_dtype` and `store_dtype` given."""
    name = str(store).removeprefix("torch.")
    np_store = ml_dtypes.bfloat16 if store == BF16 else np.float16
    arrays = _inputs(shape, [np.float32] * 2 + [np_store] * 3, seed=1)
    want = _reference(arrays, False, compute_dtype=jnp.float32, store_dtype=getattr(jnp, name))
    got = ops.elementwise_block(*map(_torch, arrays), *SCALARS, compute_dtype=F32, store_dtype=store)
    assert all(g.dtype == store for g in got[:4]) and got[4].dtype == F32
    _held(got, want, *TOL[np.float32], max(float(np.abs(a.astype(np.float64)).max()) for a in arrays))


@pytest.mark.parametrize("compute", [np.float32, np.float64], ids=["to_f32", "to_f64"])
def test_compute_dtype_only(compute):
    """Inputs in the other wide dtype cast to `compute_dtype`, outputs stored
    in it."""
    other = np.float64 if compute == np.float32 else np.float32
    arrays = _inputs(SHAPES[0], [other] * 5, seed=2)
    jdt = getattr(jnp, np.dtype(compute).name)
    want = _reference(arrays, True, compute_dtype=jdt)
    got = ops.elementwise_block(*map(_torch, arrays), *SCALARS, compute_dtype=np.dtype(compute).name)
    assert all(g.dtype == getattr(torch, np.dtype(compute).name) for g in got)
    _held(got, want, *TOL[compute], 1.0)


@pytest.mark.parametrize("store", [BF16, F16, F64], ids=["bf16", "f16", "f64"])
def test_store_dtype_only(store):
    """float32 inputs computed in float32 (no `compute_dtype`), the four
    tensors stored in `store_dtype`."""
    arrays = _inputs(SHAPES[2], [np.float32] * 5, seed=3)
    name = str(store).removeprefix("torch.")
    want = _reference(arrays, store == F64, store_dtype=getattr(jnp, name))
    got = ops.elementwise_block(*map(_torch, arrays), *SCALARS, store_dtype=store)
    assert all(g.dtype == store for g in got[:4]) and got[4].dtype == F32
    _held(got, want, *TOL[np.float32], max(float(np.abs(a).max()) for a in arrays))


def test_mixed_wide_inputs_compute_in_the_promoted_dtype():
    arrays = _inputs(SHAPES[0], [np.float64, np.float32, np.float32, np.float32, np.float64], seed=4)
    want = _reference(arrays, True)
    got = ops.elementwise_block(*map(_torch, arrays), *SCALARS)
    assert all(g.dtype == F64 for g in got)
    _held(got, want, *TOL[np.float32], 1.0)


def test_mixed_narrow_inputs_with_compute_dtype_take_the_astype_chain():
    """bf16 D and E beside float32 L, Y_L and Y_O, computed in float32 and
    stored in float16: no variant holds that mix, so on the card the call
    casts to float32, launches the pure variant and rounds the stores; on
    the CPU the plain version does the same casts, as the reference does."""
    arrays = _inputs(SHAPES[1], [ml_dtypes.bfloat16, np.float32, ml_dtypes.bfloat16, np.float32, np.float32],
                     seed=5)
    want = _reference(arrays, False, compute_dtype=jnp.float32, store_dtype=jnp.float16)
    got = ops.elementwise_block(*map(_torch, arrays), *SCALARS, compute_dtype=F32, store_dtype=F16)
    assert flat_variant(*(g.dtype for g in map(_torch, arrays)), F32, F16) is None
    _held(got, want, *TOL[np.float32], max(float(np.abs(a.astype(np.float64)).max()) for a in arrays))


@pytest.mark.parametrize("form", ["torch", "name", "numpy", "jax"])
def test_dtype_arguments_in_every_form(form):
    arrays = _inputs(SHAPES[2], [np.float32] * 5, seed=6)
    dt = {"torch": F64, "name": "float64", "numpy": np.float64, "jax": jnp.float64}[form]
    got = ops.elementwise_block(*map(_torch, arrays), *SCALARS, compute_dtype=dt, store_dtype=dt)
    want = ops.elementwise_block(*map(_torch, arrays), *SCALARS, compute_dtype=F64, store_dtype=F64)
    for g, w in zip(got, want):
        assert g.dtype == F64 and torch.equal(g, w)


def test_numpy_input_follows_the_device_rule():
    """Numpy input goes to the card (RuntimeError without CUDA), or where
    `device` says; `device="cpu"` is the tensor call bitwise."""
    arrays = _inputs(SHAPES[2], [np.float32] * 5, seed=7)
    want = ops.elementwise_block(*map(_torch, arrays), *SCALARS)
    got = ops.elementwise_block(*arrays, *SCALARS, device="cpu")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ops.elementwise_block(*arrays, *SCALARS)


def test_compute_narrower_than_float32_runs_on_the_cpu():
    """The plain version computes in bfloat16 when every input is bfloat16,
    as the reference's jnp route does (the card refuses it: no variant
    computes narrower than float32). Each bf16 operation rounds, in another
    grouping than XLA's fusion: held within four bf16 steps."""
    arrays = _inputs(SHAPES[2], [ml_dtypes.bfloat16] * 5, seed=8)
    want = _reference(arrays, False)
    got = ops.elementwise_block(*map(_torch, arrays), *SCALARS)
    scale = max(float(np.abs(a.astype(np.float64)).max()) for a in arrays)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == BF16
        np.testing.assert_allclose(_numpy(g).astype(np.float64), w.astype(np.float64), rtol=4 * 2.0**-8,
                                   atol=4 * 2.0**-8 * scale)
    for g, w in zip(got[4:], want[4:]):
        assert g.dtype == BF16
        np.testing.assert_allclose(float(g), float(w), rtol=4 * 2.0**-8)


def test_the_card_route_of_each_dtype_set():
    """One launch where the dtypes name a variant, else the cast route."""
    e4m3 = torch.float8_e4m3fn
    assert flat_variant(F32, F32, F32, F32, F32, F32, F32) == "f32"
    assert flat_variant(F64, F64, F64, F64, F64, F64, F64) == "f64"
    assert flat_variant(BF16, F32, BF16, BF16, BF16, F32, BF16) == "c32_dbf16_sbf16_tbf16"
    assert flat_variant(F32, F32, BF16, BF16, BF16, F32, BF16) == "c32_d32_sbf16_tbf16"
    assert flat_variant(F64, F32, F64, F64, F64, F32, F64) == "c32_d64_s64_t64"
    assert flat_variant(F32, F64, F32, F32, F32, F64, F32) == "c64_d32_s32_t32"
    assert flat_variant(e4m3, F64, e4m3, e4m3, e4m3, F64, e4m3) == "c64_de4m3_se4m3_te4m3"
    for dts in ((F32, F32, F32, F32, F32, F32, BF16),     # stores narrower than the inputs
                (BF16, BF16, BF16, BF16, BF16, F32, F32),  # L not in the compute dtype
                (F64, F32, F32, F32, F32, F32, F32),       # D in neither
                (F32, F32, BF16, F32, BF16, F32, BF16)):   # mixed storage
        assert flat_variant(*dts) is None
    assert set(hopper_kernels.KERNEL_VARIANTS.values()) >= {"f32", "f64", "c32_d64_s64_t64"}
