"""PyTorch port, narrow storage and einsum_dtype: the bf16 RHS contraction,
the plain narrow elementwise block, single iterations and whole solves held
against the JAX package on the same numpy inputs (the JAX-drawn init and
state carried over through tritd_tpu_torch.interop).

Tolerances, with reasons:
  * rhs_mode with einsum_dtype: rtol 1e-5 (atol 1e-5 * max) — both sides
    multiply the same bf16-rounded operands exactly in float32 and sum in
    float32, in another order.
  * bf16 tensors: one bf16 ulp, rtol 2**-8 with atol 2**-8 * max|input| —
    an f32 result an ulp or two apart (FMA, another division) can round to
    the neighbouring bf16 value; f32 sums rtol 1e-5 (another order).
  * whole solves: the first 10 err_hist entries at rtol 1e-2 and the final
    RRE within 0.03 of JAX's — bf16 roundings that flip on f32 noise feed
    back through ADMM; 0.03 is the family bound of the reference's own
    bf16-vs-f32 test (tests/test_solvers.py:255).
"""

import dataclasses
import importlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu.ops.pallas_kernels import _block_jnp  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers import init_state as j_init_state  # noqa: E402
from tritd_tpu.solvers import tritd_admm as j_tritd_admm  # noqa: E402
from tritd_tpu.solvers.admm import admm_iteration as j_admm_iteration  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu.solvers.admm import t_dtype_of as j_t_dtype_of  # noqa: E402
from tritd_tpu_torch import interop  # noqa: E402
from tritd_tpu_torch.data import make_completion_problem  # noqa: E402
from tritd_tpu_torch.ops import normal_eq  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops.hopper_kernels import _block_torch, elementwise_block  # noqa: E402
from tritd_tpu_torch.solvers import TriTDConfig, admm_iteration, init_state, t_dtype_of, tritd_admm  # noqa: E402

jne = importlib.import_module("tritd_tpu.ops.normal_eq")

BF16_ULP = 2.0**-8
SHAPE = (12, 10, 14)
R = 3
SCALARS = (0.5, 0.7, 1.8)
MU_NEXT = 0.625


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 and widened back to float32 (exact)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _assert_ulp(got: torch.Tensor, want, scale: float, what: str):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_ULP,
                               atol=BF16_ULP * scale, err_msg=what)


@pytest.mark.parametrize("variant", ["hadamard", "full"])
@pytest.mark.parametrize("mode", [1, 2, 3])
@pytest.mark.parametrize("x_narrow", [False, True], ids=["x_f32", "x_bf16"])
def test_rhs_mode_einsum_dtype_matches_jax(mode, variant, x_narrow):
    rng = np.random.default_rng(mode)
    x = rng.standard_normal(SHAPE).astype(np.float32) * 10
    if x_narrow:
        x = _bf16(x)
    cores = [rng.standard_normal(s).astype(np.float32) for s in ((12, R, R), (R, 10, R), (R, R, 14))]
    want = np.asarray(jne.rhs_mode(mode, jnp.asarray(x, jnp.bfloat16 if x_narrow else jnp.float32),
                                   *map(jnp.asarray, cores), variant=variant, einsum_dtype=jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16 if x_narrow else torch.float32)
    got = normal_eq.rhs_mode(mode, xt, *map(torch.from_numpy, cores), variant=variant,
                             einsum_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the operands really were rounded: the full-precision RHS differs
    full = normal_eq.rhs_mode(mode, xt.float(), *map(torch.from_numpy, cores), variant=variant)
    assert not torch.equal(full, got)


def test_rhs_mode_einsum_dtype_keeps_f64_factors():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(SHAPE)
    cores = [rng.standard_normal(s) for s in ((12, R, R), (R, 10, R), (R, R, 14))]
    with jax.enable_x64(True):
        want = np.asarray(jne.rhs_mode(2, jnp.asarray(x), *map(jnp.asarray, cores), einsum_dtype=jnp.bfloat16))
    got = normal_eq.rhs_mode(2, torch.from_numpy(x), *map(torch.from_numpy, cores), einsum_dtype=torch.bfloat16)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# (D, storage, T') of the three narrow combinations the solver produces,
# compute float32: storage_dtype unmasked, storage_dtype masked (D imputed
# in f32, no T'), einsum_dtype alone (storage f32, T' bf16)
NARROW_BLOCKS = {
    "storage": ("bfloat16", "bfloat16", "bfloat16"),
    "masked_storage": ("float32", "bfloat16", None),
    "einsum_only": ("float32", "float32", "bfloat16"),
}


@pytest.mark.parametrize("case", list(NARROW_BLOCKS))
@pytest.mark.parametrize("shape", [(17, 23, 31), (5, 7, 11)])
def test_plain_narrow_block_matches_jax(case, shape):
    d_dt, s_dt, t_dt = NARROW_BLOCKS[case]
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(shape).astype(np.float32) * 3 for _ in range(5)]
    # inputs as the solver holds them: D and E/Y_L/Y_O in their stored dtype
    arrays = [
        _bf16(a) if (i == 0 and d_dt == "bfloat16") or (i >= 2 and s_dt == "bfloat16") else a
        for i, a in enumerate(arrays)
    ]
    dtypes = (d_dt, "float32", s_dt, s_dt, s_dt)
    j_in = [jnp.asarray(a).astype(dt) for a, dt in zip(arrays, dtypes)]
    narrow = s_dt == "bfloat16"
    o, e, y_l, y_o, nl, no = _block_jnp(*j_in, *SCALARS, compute_dtype=jnp.float32 if narrow else None,
                                        store_dtype=jnp.bfloat16 if narrow else None)
    want = [np.asarray(v.astype(jnp.float32)) for v in (o, e, y_l, y_o)]
    t_in = [torch.from_numpy(a).to(getattr(torch, dt)) for a, dt in zip(arrays, dtypes)]
    mu_next = None if t_dt is None else MU_NEXT
    got = elementwise_block(*t_in, *SCALARS, mu_l_next=mu_next,
                            t_dtype=None if t_dt is None else getattr(torch, t_dt))
    scale = max(np.abs(a).max() for a in arrays)
    for name, g, w in zip(("o", "e", "y_l", "y_o"), got[:4], want):
        assert g.dtype == getattr(torch, s_dt), name
        _assert_ulp(g, w, scale, name)
    for g, w in zip(got[4:6], (nl, no)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    if t_dt is None:
        assert got[6] is None
        return
    # T' as the reference's solver forms it: from D and the STORED O', Y_L'
    # (tritd_tpu/solvers/admm.py:159-163)
    t_want = (j_in[0].astype(jnp.float32) - o.astype(jnp.float32)
              + y_l.astype(jnp.float32) / jnp.float32(MU_NEXT)).astype(jnp.bfloat16)
    assert got[6].dtype == torch.bfloat16
    _assert_ulp(got[6], np.asarray(t_want.astype(jnp.float32)), scale, "t")


def test_narrow_t_is_built_from_the_rounded_outputs():
    """T' = D - S(O') + S(Y_L')/muL_next with S the bf16 rounding, not the
    f32 register values (the trap in a direct port of the f32 kernel)."""
    rng = np.random.default_rng(11)
    args = [torch.from_numpy(rng.standard_normal((6, 7, 8)).astype(np.float32)) for _ in range(5)]
    args = [args[0].bfloat16(), args[1], *(a.bfloat16() for a in args[2:])]
    o, _e, y_l, _yo, _nl, _no, t = _block_torch(*args, *SCALARS, mu_l_next=MU_NEXT,
                                                compute_dtype=torch.float32, store_dtype=torch.bfloat16)
    want = (args[0].float() - o.float() + y_l.float() / MU_NEXT).bfloat16()
    torch.testing.assert_close(t, want, rtol=0, atol=0)


def _truncate_to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 rounding toward zero (drop the low 16 bits)."""
    return (x.view(torch.int32) & -65536).view(torch.float32).bfloat16()


@pytest.mark.parametrize("case", ["storage", "einsum_only"])
def test_narrow_check_rejects_unrounded_t_and_truncation(case):
    """The check that holds a narrow kernel variant against the plain
    version on the card passes the plain outputs themselves, and fails a
    kernel that forms T' from the unrounded O' and Y_L', or that truncates
    where it should round to nearest even. Both stay within the one-ulp
    tolerance in nearly every element."""
    d_dt, s_dt, t_dt = (getattr(torch, n) for n in NARROW_BLOCKS[case])
    rng = np.random.default_rng(12)
    raw = [torch.from_numpy(rng.standard_normal((24, 20, 28)).astype(np.float32) * 3) for _ in range(5)]
    args = [raw[0].to(d_dt), raw[1], *(x.to(s_dt) for x in raw[2:])]
    want = _block_torch(*args, *SCALARS, mu_l_next=MU_NEXT, compute_dtype=torch.float32,
                        store_dtype=s_dt, t_dtype=t_dt)
    ok = hopper_kernels.check_narrow_against_plain(args, want, want, MU_NEXT)
    assert ok == {"max_abs_err": 0.0, "flip_share": 0.0}
    # the same block kept in float32 registers, unrounded
    o, e, y_l, y_o, nl, no, t32 = _block_torch(*args, *SCALARS, mu_l_next=MU_NEXT, compute_dtype=torch.float32)
    if s_dt == torch.bfloat16:
        with pytest.raises(AssertionError, match="from the stored O' and Y_L'"):
            hopper_kernels.check_narrow_against_plain(args, (*want[:6], t32.bfloat16()), want, MU_NEXT)
        stored = [_truncate_to_bf16(x) for x in (o, e, y_l, y_o)]
        # T' consistent with the truncated stores, so only their rounding is wrong
        t = (args[0].float() - stored[0].float() + stored[2].float() / MU_NEXT).bfloat16()
        match = "rounded otherwise than the plain version"
    else:
        stored = [o, e, y_l, y_o]
        t = _truncate_to_bf16(args[0].float() - o + y_l / MU_NEXT)
        match = "from the stored O' and Y_L'"
    with pytest.raises(AssertionError, match=match):
        hopper_kernels.check_narrow_against_plain(args, (*stored, nl, no, t), want, MU_NEXT)


@pytest.mark.parametrize("fields", [
    dict(), dict(storage_dtype="bfloat16"), dict(einsum_dtype="bfloat16"),
    dict(storage_dtype="bfloat16", einsum_dtype="bfloat16"),
    dict(storage_dtype="bfloat16", dtype="float64"),
], ids=["none", "storage", "einsum", "both", "storage_f64"])
def test_t_dtype_and_init_state_match_jax(fields):
    cfg = TriTDConfig(rank=R, **fields)
    want = j_t_dtype_of(JConfig(**dataclasses.asdict(cfg)))
    got = t_dtype_of(cfg)
    assert (got is None and want is None) or str(got).removeprefix("torch.") == str(want)
    d = torch.ones(SHAPE, dtype=cfg.torch_dtype())
    init = [np.ones(s) for s in ((12, R, R), (R, 10, R), (R, R, 14))]
    state = init_state(d, cfg, init)
    assert state.o.dtype == state.y_o.dtype == cfg.torch_storage_dtype()
    assert state.t.dtype == (got or cfg.torch_dtype())
    assert state.a.dtype == state.err_hist.dtype == cfg.torch_dtype()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("fields", [dict(storage_dtype="bfloat16"), dict(einsum_dtype="bfloat16")],
                         ids=["storage", "einsum"])
def test_admm_iteration_from_jax_narrow_state(fields, masked):
    """One iteration from the reference's own narrow state (bf16 fields
    carried over bit for bit) lands on its next state within one bf16 ulp."""
    x, spiked, mask = _problem(1)
    y = np.where(mask, spiked, 0.0).astype(np.float32)
    cfg = TriTDConfig(rank=R, masked=masked, lambda_l1=0.1, **fields)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jd = jnp.asarray(y, jnp.float32)
    jmask = jnp.asarray(mask) if masked else None
    s = j_init_state(jd, jcfg, jax.random.PRNGKey(3))
    # the solvers take ||D|| from the full-precision D
    norm_d = np.linalg.norm(y.astype(np.float64)).astype(np.float32)
    jd = jd.astype(jcfg.jnp_storage_dtype())
    for _ in range(3):
        s = j_admm_iteration(jd, s, jcfg, mask=jmask, norm_d=jnp.asarray(norm_d))
    start = {f: np.asarray(getattr(s, f)) for f in s._fields}
    s = j_admm_iteration(jd, s, jcfg, mask=jmask, norm_d=jnp.asarray(norm_d))
    want = {f: np.asarray(getattr(s, f)) for f in s._fields}
    state = interop.state_from_numpy(start, device="cpu")
    assert state.k == 3 and state.o.dtype == cfg.torch_storage_dtype()
    d = interop.tensor_from_numpy(np.asarray(jd), device="cpu")
    got = admm_iteration(d, state, cfg, mask=torch.from_numpy(mask) if masked else None,
                         norm_d=torch.tensor(norm_d))
    assert got.mu_l == want["mu_l"] and got.k == 4
    scale = np.abs(y).max()
    for f in ("o", "e", "y_l", "y_o", "t"):
        g = getattr(got, f)
        assert str(g.dtype).removeprefix("torch.") == str(want[f].dtype), f
        _assert_ulp(g, want[f].astype(np.float32), scale, f)
    for f in ("a", "b", "c"):
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f], rtol=1e-3,
                                   atol=1e-4 * np.abs(want[f]).max(), err_msg=f)
    np.testing.assert_allclose(got.err_hist[:4].numpy(), want["err_hist"][:4], rtol=1e-4)


def _problem(seed=0, missing=0.3):
    """(truth, truth + 5% of +-5 spikes, mask of observed entries); the
    truth is low-TriTD-rank with unit RMS."""
    rng = np.random.default_rng(seed)
    n1, n2, n3 = SHAPE
    a, b, c = (rng.standard_normal(s) for s in ((n1, 2, 2), (2, n2, 2), (2, 2, n3)))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = x / np.sqrt(np.mean(x**2))
    spikes = (rng.random(SHAPE) < 0.05) * np.where(rng.random(SHAPE) < 0.5, 5.0, -5.0)
    mask = np.ones(x.size, bool)
    mask[rng.permutation(x.size)[: int(round(missing * x.size))]] = False
    mask = mask.reshape(SHAPE)
    return x.astype(np.float32), (x + spikes).astype(np.float32), mask


SOLVES = {
    "storage": (dict(storage_dtype="bfloat16"), False),
    "storage_masked": (dict(storage_dtype="bfloat16", masked=True, lambda_l1=1.8), True),
    "einsum": (dict(einsum_dtype="bfloat16"), False),
    "storage_einsum": (dict(storage_dtype="bfloat16", einsum_dtype="bfloat16"), False),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_narrow_solve_matches_jax(case):
    fields, masked = SOLVES[case]
    if masked:
        # 30% missing, no spikes, as the reference's
        # test_admm_bf16_storage_masked_mode
        prob = make_completion_problem(np.random.default_rng(0), shape=SHAPE, rank=2, missing_ratio=0.3)
        x, d, mask = prob["x"], prob["y"], prob["mask"]
    else:
        x, d, mask = _problem()  # every entry seen, with spikes
    cfg = TriTDConfig(**{"rank": 2, "max_iter": 80, "tol": 1e-7, "lambda_l1": 0.1, **fields})
    init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, 2, jnp.float32)]
    jres = j_tritd_admm(jnp.asarray(d), JConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0),
                        mask=jnp.asarray(mask) if masked else None, origin=jnp.asarray(x))
    res = tritd_admm(torch.from_numpy(d), cfg, mask=torch.from_numpy(mask) if masked else None,
                     origin=torch.from_numpy(x), init=init)
    assert res.o.dtype == res.e.dtype == torch.float32  # back in cfg.dtype
    assert res.a.dtype == res.err_hist.dtype == torch.float32
    n, jn = res.n_iters, int(jres.n_iters)
    got, want = res.err_hist.numpy(), np.asarray(jres.err_hist)
    assert np.isfinite(got[:n]).all() and n > 10 and jn > 10
    np.testing.assert_allclose(got[:10], want[:10], rtol=1e-2)
    rre, j_rre = float(res.rre_hist[n - 1]), float(np.asarray(jres.rre_hist)[jn - 1])
    assert abs(rre - j_rre) < 0.03, (rre, j_rre)
    assert rre < (0.12 if masked else 0.1)


def test_bf16_storage_stays_in_family_with_f32():
    """As the reference's test_admm_bf16_storage_matches_f32: narrow storage
    lands within 0.03 RRE of the float32 run from the same init."""
    x, d, _mask = _problem(4)
    base = dict(rank=2, max_iter=80, tol=1e-7, lambda_l1=0.1)
    init = [np.random.default_rng(5).standard_normal(s) for s in ((12, 2, 2), (2, 10, 2), (2, 2, 14))]
    r32 = tritd_admm(torch.from_numpy(d), TriTDConfig(**base), origin=torch.from_numpy(x), init=init)
    r16 = tritd_admm(torch.from_numpy(d), TriTDConfig(**base, storage_dtype="bfloat16"),
                     origin=torch.from_numpy(x), init=init)
    rre32 = float(r32.rre_hist[r32.n_iters - 1])
    rre16 = float(r16.rre_hist[r16.n_iters - 1])
    assert rre16 < 0.1 and abs(rre16 - rre32) < 0.03


def test_kernel_variants_cover_the_solver_and_reject_the_rest():
    """Every dtype combination a solve can hand the block has a kernel
    variant, and each variant one C entry point in the source; others raise
    TypeError before anything is built or launched."""
    from tritd_tpu_torch.runtime import build, kernels

    src = "".join(p.read_text() for p in build.sources())
    entries = re.findall(r"^TRITD_BLOCK_ENTRY\(tritd_elementwise_block_(\w+),", src, re.M)
    assert sorted(entries) == sorted(hopper_kernels.KERNEL_VARIANTS.values())
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    for cd in (f32, f64):
        for d_dt, s_dt, t_dt in ((cd, cd, cd), (bf16, bf16, bf16), (cd, bf16, bf16), (cd, cd, bf16)):
            args = [torch.zeros(2, 3, 4, dtype=dt) for dt in (d_dt, cd, s_dt, s_dt, s_dt)]
            variant = hopper_kernels.kernel_variant(*args, t_dtype=t_dt)
            assert variant in entries
            assert f"elementwise_block[{variant}]" in hopper_kernels.LAUNCHES
    bad = [
        (bf16, f32, f32, f32, f32, None),       # D narrow, storage wide
        (f32, f32, bf16, bf16, bf16, f32),      # T' wider than the storage
        (f32, f32, bf16, f32, bf16, None),      # mixed storage
        (f32, torch.float16, f32, f32, f32, None),  # L not f32/f64
        (f64, f32, f32, f32, f32, None),        # D in another wide dtype than the storage
    ]
    for *dts, t_dt in bad:
        args = [torch.zeros(2, 3, 4, dtype=dt) for dt in dts]
        with pytest.raises(TypeError, match="float32 or float64|mixed dtypes"):
            hopper_kernels._block_cuda(*args, *SCALARS, mu_l_next=MU_NEXT, t_dtype=t_dt)
    assert kernels.library.cache_info().currsize == 0
