"""PyTorch port, the launch plan of the elementwise-block kernel: what the
wrapper decides in Python before it launches (`ops/hopper_kernels.py`), none
of which needs a card. The group a thread takes per turn, the grid as a
function of n alone, the choice between 16-byte accesses and the
one-element path from the pointers' alignment, the scratch kept per device
and stream, and the wrapper's geometry against the constants in the CUDA
source. Also the block on CPU tensors that are misaligned views or of odd
sizes against both JAX routes at float64, rtol 1e-12 (the elementwise
arithmetic is the same; the sums are taken in another order)."""

import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu.ops.pallas_kernels import elementwise_block as j_block  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops.hopper_kernels import (  # noqa: E402
    BLOCK_THREADS,
    KERNEL_VARIANTS,
    RESIDENT_BLOCKS,
    VARIANT_GROUP,
    block_grid,
    elementwise_block,
    group_size,
    pointers_aligned,
)
from tritd_tpu_torch.runtime import build, kernels  # noqa: E402
from tritd_tpu_torch.tools import sweep_block  # noqa: E402

SCALARS = (0.5, 0.7, 1.8)
MU_NEXT = 0.625
# the sizes the smoke run's phase 2 holds on the card, the slabs of a
# sharded solve, and the taxi and video shapes
ODD_ABOVE_A_WAVE = 2 * RESIDENT_BLOCKS * BLOCK_THREADS * 8 + 13
SIZES = [1, 7, 8, 9, 255, 257, ODD_ABOVE_A_WAVE, 17 * 23 * 31, 25 * 100 * 500, 34 * 100 * 500,
         100 * 100 * 500, 240 * 320 * 300]
SIZE_OF = {torch.float32: 4, torch.float64: 8, torch.bfloat16: 2, torch.float16: 2,
           torch.float8_e4m3fn: 1, torch.float8_e5m2: 1}
# The accesses narrower than 16 bytes, by (bytes of the widest type, bytes
# of the element): the 32-byte cap on the widest type leaves the narrowest
# streams short. Four 2-byte elements beside double move 8 bytes; eight
# float8 beside float 8 bytes; four float8 beside double 4 bytes.
SHORT_ACCESS = {(8, 2): 8, (4, 1): 8, (8, 1): 4}
VARIANTS = sorted(KERNEL_VARIANTS.values())


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtypes(variant):
    (key,) = (k for k, v in KERNEL_VARIANTS.items() if v == variant)
    return key


def _widest(variant):
    return max(SIZE_OF[dt] for dt in _dtypes(variant))


@pytest.mark.parametrize("variant", VARIANTS)
def test_group_moves_16_bytes_of_the_narrowest_stream(variant):
    key = _dtypes(variant)
    group = VARIANT_GROUP[variant]
    widest = _widest(variant)
    assert group == group_size(widest, min(SIZE_OF[dt] for dt in key))
    # at most 32 bytes of the widest type a turn (the compute type, but for
    # a double stream beside float compute); every stream then moves 16
    # bytes or a multiple, but for the SHORT_ACCESS cases
    assert group * widest <= 32
    for dt in key:
        moved = group * SIZE_OF[dt]
        assert moved % 16 == 0 or moved == SHORT_ACCESS.get((widest, SIZE_OF[dt]))
    # float compute takes 8 elements beside 2-byte or float8 streams, 4
    # beside only floats or beside a double stream; double compute 4, or 2
    # with every stream double
    wide_stream = variant.startswith("c32") and "64" in variant[3:]
    want = 4 if wide_stream else 8 if variant.startswith("c32") else 4
    assert {"f32": 4, "f64": 2}.get(variant, want) == group


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_grid_is_one_resident_wave_of_whole_turns(variant, n):
    group = VARIANT_GROUP[variant]
    grid = block_grid(n, group)
    assert 1 <= grid <= RESIDENT_BLOCKS
    groups = -(-n // group)
    want = max(1, -(-groups // BLOCK_THREADS))  # blocks if every thread took one group
    turns = -(-want // grid)
    assert grid * turns * BLOCK_THREADS * group >= n  # every element has a thread
    if want <= RESIDENT_BLOCKS:
        assert grid == want and turns == 1
    else:
        assert (turns - 1) * RESIDENT_BLOCKS < want  # the fewest turns that fit
        assert grid * turns - want < turns            # and no block more than needed for them
    # the same n gives the same grid, whatever was planned in between
    block_grid(n + 12345, group)
    assert block_grid(n, group) == grid


def test_grid_of_the_quarter_slab_leaves_no_part_filled_wave():
    # 25x100x500 in groups of 4: 1221 blocks' worth of groups in 5 turns of 245
    assert block_grid(25 * 100 * 500, 4) == 245
    assert block_grid(100 * 100 * 500, 4) * 19 >= 4883 > block_grid(100 * 100 * 500, 4) * 18


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("offset", [0, 1, 3, 4, 8, 16])
def test_vector_path_needs_every_pointer_16_byte_aligned(size, offset):
    base = 0x7F0000000000
    good = [base + 512 * k for k in range(10)]
    assert pointers_aligned(*good)
    for k in range(10):
        moved = list(good)
        moved[k] += offset * size
        assert pointers_aligned(*moved) == ((offset * size) % 16 == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16], ids=str)
def test_a_contiguous_view_can_be_misaligned(dtype):
    fresh = [torch.zeros(40, dtype=dtype) for _ in range(5)]
    assert pointers_aligned(*(x.data_ptr() for x in fresh))
    views = [torch.zeros(41, dtype=dtype)[1:] for _ in range(5)]
    assert all(v.is_contiguous() for v in views)
    assert not pointers_aligned(*(v.data_ptr() for v in views))
    # a row of a stacked buffer is aligned only if a row's bytes are a multiple of 16
    rows = torch.zeros((4, 3, 5), dtype=dtype).unbind(0)
    assert pointers_aligned(*(r.data_ptr() for r in rows)) == ((15 * SIZE_OF[dtype]) % 16 == 0)
    # one misaligned pointer among the ten is enough for the one-element path
    assert not pointers_aligned(*(x.data_ptr() for x in fresh), views[0].data_ptr())


def test_scratch_is_kept_per_device_and_stream():
    made = []

    def make():
        made.append(torch.zeros(hopper_kernels.SCRATCH_LEN, dtype=torch.float64))
        return made[-1]

    keys = [("stand-in device 0", 11), ("stand-in device 0", 12), ("stand-in device 1", 11)]
    try:
        first = [hopper_kernels._scratch_for(k, make) for k in keys]
        again = [hopper_kernels._scratch_for(k, make) for k in keys]
        assert len(made) == 3 and all(a is b for a, b in zip(first, again))
        assert len({x.data_ptr() for x in first}) == 3  # no two streams share a counter
        assert all(x.shape == (2 * RESIDENT_BLOCKS + 1,) and not x.any() for x in first)
    finally:
        for k in keys:
            hopper_kernels._SCRATCH.pop(k, None)


def test_plan_constants_are_those_of_the_cuda_source():
    src = (build.SRC_DIR / "elementwise_block.cuh").read_text()
    const = {name: int(value) for name, value in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kThreads"] == BLOCK_THREADS
    assert const["kSMs"] * const["kBlocksPerSM"] == RESIDENT_BLOCKS
    assert "kMaxBlocks = kSMs * kBlocksPerSM;" in src
    assert "finalize_kernel" not in src and src.count("<<<") == 1  # one launch a call
    assert "atomicAdd(counter, 1u)" in src and "__ldcg(scratch" in src
    assert hopper_kernels.SCRATCH_LEN == 2 * RESIDENT_BLOCKS + 1


@pytest.mark.parametrize("wrong", ["threads", "blocks", "scratch", "group"])
def test_entry_refuses_a_library_built_with_another_geometry(monkeypatch, wrong):
    built = {"threads": BLOCK_THREADS, "blocks": RESIDENT_BLOCKS, "scratch": hopper_kernels.SCRATCH_LEN,
             "group": VARIANT_GROUP["f32"]}
    built[wrong] += 1
    lib = types.SimpleNamespace(
        tritd_block_threads=lambda: built["threads"], tritd_max_blocks=lambda: built["blocks"],
        tritd_scratch_len=lambda: built["scratch"], tritd_elementwise_block_f32_group=lambda: built["group"],
        tritd_elementwise_block_f32=lambda *a: 0)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    hopper_kernels._entry.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="differ from this module's"):
            hopper_kernels._entry("f32")
        built[wrong] -= 1
        fn, group, key = hopper_kernels._entry("f32")
        assert fn is lib.tritd_elementwise_block_f32 and group == 4 and key == "elementwise_block[f32]"
    finally:
        hopper_kernels._entry.cache_clear()


@pytest.mark.parametrize("name", list(sweep_block.VARIATIONS))
def test_sweep_variations_still_apply_to_the_source(name):
    """Each variation of `tools/sweep_block` is a set of substitutions that
    must hit the kernel's source as often as it says, and overrides of names
    that the wrapper's module has."""
    subs, overrides, _sums_valid = sweep_block.VARIATIONS[name]
    text = sweep_block.SOURCE.read_text()
    varied = sweep_block.vary(text, subs)
    assert (varied != text) == bool(subs)
    assert all(hasattr(hopper_kernels, k) for k in overrides)
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        sweep_block.vary(text, [("no such line in the source", "", 1)])


def _shifted(a):
    """The same values as a view one element past an aligned buffer."""
    flat = np.concatenate([np.zeros(1, a.dtype), a.ravel()])
    view = torch.from_numpy(flat)[1:].view(a.shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.parametrize("layout", ["aligned", "shifted"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape", [(1, 1, 7), (3, 3, 1), (257, 1, 1), (17, 23, 31), (5, 7, 11)], ids=str)
def test_block_on_views_and_odd_sizes_matches_jax_f64(shape, use_pallas, layout):
    rng = np.random.default_rng(sum(shape))
    arrays = [rng.standard_normal(shape) for _ in range(5)]
    with jax.enable_x64(True):
        want = [np.asarray(v) for v in j_block(*map(jnp.asarray, arrays), *SCALARS,
                                               use_pallas=use_pallas, interpret=use_pallas)]
    tensors = [_shifted(a) if layout == "shifted" else torch.from_numpy(a) for a in arrays]
    got = elementwise_block(*tensors, *SCALARS, mu_l_next=MU_NEXT)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.float64 and g.shape == shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
    for g, w in zip(got[4:6], want[4:6]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12)
    t_want = arrays[0] - want[0] + want[2] / MU_NEXT
    np.testing.assert_allclose(got[6].numpy(), t_want, rtol=1e-12, atol=1e-12)


def _group_of_source():
    """The source's GroupOf as a function of (widest bytes, narrowest
    bytes): its two constants, read from csrc/elementwise_block.cuh."""
    src = (build.SRC_DIR / "elementwise_block.cuh").read_text()
    by_stream = int(re.search(r"kByStream = (\d+) / kNarrowest;", src).group(1))
    cap = int(re.search(r"kCap = (\d+) / kWidest;", src).group(1))
    return lambda widest, narrowest: min(by_stream // narrowest, cap // widest)


@pytest.mark.parametrize("variant", VARIANTS)
def test_group_table_is_the_sources_group_of(variant):
    """VARIANT_GROUP, which the wrapper plans with, against GroupOf in the
    CUDA source (which `_entry` also holds against the built library)."""
    key = _dtypes(variant)
    assert VARIANT_GROUP[variant] == _group_of_source()(_widest(variant), min(SIZE_OF[dt] for dt in key))


# An excerpt in the form `cuobjdump -sass` prints: a prologue, a loop whose
# backward branch encloses a 16-byte load, a division's skipped slow-path
# call inside it, a one-element loop after it, and a label-form branch.
SASS_EXCERPT = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_124elementwise_block_kernelIf4e5m2S1_S1_EEvv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                             /* 0x00000a00ff017b82 */
                                                                                      /* 0x000fe40000000800 */
        /*0010*/                   MUFU.RCP R15, R2 ;                                 /* 0x00000002000f7308 */
        /*0020*/              @!P0 BRA 0x100 ;                                        /* 0x0000000000007947 */
        /*0030*/                   LDG.E.EF.64 R4, desc[UR8][R2.64] ;
        /*0040*/                   LDG.E.EF.128 R8, desc[UR8][R6.64] ;
        /*0050*/                   PRMT R12, R4, 0x1404, RZ ;
        /*0060*/                   HADD2.F32 R13, -RZ, R12.H0_H0 ;
        /*0070*/                   FFMA R14, R13, R15, RZ ;
        /*0080*/                   FSETP.GEU.OR P1, PT, |R14|, 61440, P1 ;
        /*0090*/              @!P1 BRA 0xb0 ;
        /*00a0*/                   CALL.REL.NOINC 0x200 ;
        /*00b0*/                   F2FP.SATFINITE.E5M2.F32.PACK_AB R16, R14, R13 ;
        /*00c0*/                   F2F.F64.F32 R18, R14 ;
        /*00d0*/                   DFMA R20, R18, R18, R20 ;
        /*00e0*/                   STG.E desc[UR8][R2.64], R16 ;
        /*00f0*/               @P2 BRA 0x30 ;
        /*0100*/                   LDG.E.U8 R4, desc[UR8][R2.64] ;
        /*0110*/                   IADD3 R2, P0, R2, 0x1, RZ ;
        /*0120*/               @P3 BRA `(.L_x_1) ;
        /*0130*/                   EXIT ;
.L_x_1:
        /*0140*/                   BRA 0x100 ;
"""


def test_sass_parser_counts_the_vector_loop():
    functions = sweep_block.parse_sass(SASS_EXCERPT)
    (name,) = functions
    insns = functions[name]
    assert len(insns) == 21 and insns[1]["op"] == "MUFU.RCP"
    assert [x["target"] for x in insns if x["op"] == "BRA"] == [0x100, 0xB0, 0x30, 0x140, 0x100]
    loop = sweep_block.vector_loop(insns)
    assert (loop[0]["addr"], loop[-1]["addr"]) == (0x30, 0xF0)  # not the one-element loop at 0x100-0x140
    counts = sweep_block.count_kinds(loop)
    assert counts == {"fp32": 3, "fp64": 1, "convert": 2, "integer": 1, "mufu": 0, "branch": 3, "memory": 3,
                      "other": 0, "total": 13}
    # the hot path takes the guarded branch over the slow-path call
    assert [x["pred"] for x in insns if x["op"] == "BRA"] == ["@!P0", "@!P1", "@P2", "@P3", ""]
    hot = sweep_block.hot_path(loop)
    assert [x["op"] for x in hot if x["op"].startswith(("BRA", "CALL"))] == ["BRA", "BRA"]
    assert sweep_block.count_kinds(hot) == {**counts, "branch": 2, "total": 12}
    with pytest.raises(ValueError, match="16-byte global load"):
        sweep_block.vector_loop([x for x in insns if ".128" not in x["op"]])


def test_sass_budget_and_kernel_names():
    # 13 B an element at 3.35 TB/s leaves 132 SMs x 128 lanes at 1980 MHz about 130 instructions
    assert sweep_block.issue_budget(13, 1980) == pytest.approx(129.82, abs=0.01)
    assert sweep_block.issue_budget(40, 1980) == pytest.approx(399.45, abs=0.01)
    assert sweep_block.kernel_types("c32_de5m2_se5m2_te5m2") == "float, e5m2, e5m2, e5m2"
    assert sweep_block.kernel_types("c64_d64_sbf16_tbf16") == "double, double, __nv_bfloat16, __nv_bfloat16"
    assert sweep_block.kernel_types("f32") == "float, float, float, float"


@pytest.mark.parametrize("variant", VARIANTS)
def test_sweep_solve_of_each_variant_routes_to_it(variant):
    """`sweep_block --solves` runs one solve per variant: its configuration
    must make the solver launch that variant (dtypes as admm_iteration
    passes them to the block)."""
    from tritd_tpu_torch.solvers import TriTDConfig
    from tritd_tpu_torch.solvers.admm import t_dtype_of

    dataset, fields = sweep_block.variant_solve(variant)
    cfg = TriTDConfig(**fields)
    compute, storage = cfg.torch_dtype(), cfg.torch_storage_dtype()
    d_dt = compute if cfg.masked else storage
    t_dt = storage if cfg.masked else (t_dtype_of(cfg) or storage)
    assert KERNEL_VARIANTS[(compute, d_dt, storage, t_dt)] == variant
    assert (dataset == "video") == (torch.float8_e4m3fn in _dtypes(variant))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_quotient_divisors_follow_the_presets_annealing(dtype):
    """The divisors the card's division check takes: mu annealed as the
    given presets anneal it (mu, min(mu * rho, cap), ...), in `dtype`, with
    each sum mu_L + mu_O, beside a power of two and an all-ones significand
    at each exponent from -32 to 31."""
    from tritd_tpu_torch.solvers import TriTDConfig

    np_dt = np.float32 if dtype == torch.float32 else np.float64
    bare = sweep_block.quotient_divisors(dtype, ())
    ones = 2.0 - 2.0 ** -np.finfo(np_dt).nmant
    assert bare == sorted(float(np_dt(m * 2.0**k)) for k in range(-32, 32) for m in (1.0, ones))
    cfg = TriTDConfig(mu=0.3, rho=2.0, mu_cap_factor=10.0, max_iter=5)
    annealed = [np_dt(0.3)]
    for _ in range(5):
        annealed.append(np.minimum(annealed[-1] * np_dt(2.0), np_dt(0.3 * 10.0)))
    want = {float(m) for m in annealed} | {float(m + m) for m in annealed}
    got = set(sweep_block.quotient_divisors(dtype, (cfg,))) - set(bare)
    assert got == want - set(bare) and float(np_dt(3.0)) in got


def test_every_case_times_each_variant_at_taxi_and_float32_at_video():
    cases = sweep_block.every_case()
    assert len(cases) == len(set(cases))
    assert {v for v, s in cases if s == "taxi"} == set(VARIANTS)
    assert {v for v, s in cases if s == "video"} == {v for v in VARIANTS if _dtypes(v)[0] == torch.float32}
