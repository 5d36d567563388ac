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
# The accesses narrower than 16 bytes, by (compute, bytes of the element):
# the 32-byte cap on the compute type leaves the narrowest streams short.
# Four 2-byte elements beside double move 8 bytes; eight float8 beside
# float 8 bytes; four float8 beside double 4 bytes.
SHORT_ACCESS = {(torch.float64, 2): 8, (torch.float32, 1): 8, (torch.float64, 1): 4}
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


@pytest.mark.parametrize("variant", VARIANTS)
def test_group_moves_16_bytes_of_the_narrowest_stream(variant):
    compute, *stored = _dtypes(variant)
    group = VARIANT_GROUP[variant]
    assert group == group_size(SIZE_OF[compute], min(SIZE_OF[dt] for dt in stored))
    # at most 32 bytes of the compute type a turn; every stream then moves
    # 16 bytes or a multiple, but for the SHORT_ACCESS cases
    assert group * SIZE_OF[compute] <= 32
    for dt in (compute, *stored):
        moved = group * SIZE_OF[dt]
        assert moved % 16 == 0 or moved == SHORT_ACCESS.get((compute, SIZE_OF[dt]))
    assert {"f32": 4, "f64": 2}.get(variant, 8 if variant.startswith("c32") else 4) == group


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
