"""PyTorch port on an NVIDIA GPU: the hand-written elementwise-block kernel
against its plain PyTorch version, and a short solve that must launch the
kernel once per iteration. Skipped with a reason where CUDA is absent.

This file imports no JAX, so it also runs on a machine without it; there,
skip the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: tensors rtol 1e-6 with atol 1e-6 * max|input| — nvcc contracts
`a*b + c` into one FMA and PyTorch's CUDA division by a host scalar
multiplies by its reciprocal, so single outputs differ by an ulp or two and
more where terms cancel; bf16 tensors one bf16 ulp (rtol 2**-8, atol
2**-8 * max|input|), since such an ulp in the compute dtype can flip a
rounding to bf16; norms rtol 1e-5 — the kernel sums in double, the plain
version in the dtype, in another order. The narrow variants also go
through `hopper_kernels.check_narrow_against_plain`: at most a share
NARROW_FLIP_SHARE of each bf16 output rounded otherwise than the plain
version (or NARROW_FLIP_FLOOR elements), and T' bitwise the rounding of
D - O' + Y_L'/muL_next from the kernel's own stored O' and Y_L'.

The SVT routes and the baselines launch no kernel of this package (they run
on torch.linalg and torch.matmul); their cases here hold the float32 CUDA
run to a float64 CPU run of the same code: SVT outputs rtol 1e-4 of ||M||,
err_hist of 10 iterations rtol 1e-3 (float32 rounding carried through the
discontinuous `>1` gate)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tritd_tpu_torch.cli.run_completion import run_method  # noqa: E402
from tritd_tpu_torch.data.loaders import DatasetSpec, synthetic_traffic  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops import svt as svt_ops  # noqa: E402
from tritd_tpu_torch.runtime import native  # noqa: E402
from tritd_tpu_torch.solvers import init_factors, tritd_admm  # noqa: E402
from tritd_tpu_torch.utils.config import COMPLETION_TRITD  # noqa: E402

SCALARS = (0.5, 0.7, 1.8)
MU_NEXT = 0.625


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_t", [False, True], ids=["no_t", "t"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(17, 23, 31), (8, 128, 4), (1, 1, 1), (100, 100, 500)])
def test_kernel_matches_plain(cuda_device, shape, dtype, with_t):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    args = [torch.randn(shape, generator=gen, dtype=dtype, device=cuda_device) for _ in range(5)]
    mu_next = MU_NEXT if with_t else None
    key = f"elementwise_block[{hopper_kernels.kernel_variant(*args)}]"
    before = hopper_kernels.LAUNCHES[key]
    got = hopper_kernels.elementwise_block(*args, *SCALARS, mu_l_next=mu_next)
    torch.cuda.synchronize()
    assert hopper_kernels.LAUNCHES[key] == before + 1
    want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next)
    atol = 1e-6 * max(float(a.abs().max()) for a in args)
    for i in (0, 1, 2, 3):
        assert got[i].dtype == dtype and got[i].shape == shape
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=atol)
    for i in (4, 5):
        assert got[i].shape == () and got[i].device.type == "cuda"
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
    if with_t:
        torch.testing.assert_close(got[6], want[6], rtol=1e-6, atol=atol)
    else:
        assert got[6] is None


@pytest.mark.cuda
def test_kernel_sums_are_deterministic(cuda_device):
    args = [torch.randn(240, 320, 30, device=cuda_device) for _ in range(5)]
    first = hopper_kernels.elementwise_block(*args, *SCALARS)
    again = hopper_kernels.elementwise_block(*args, *SCALARS)
    assert float(first[4]) == float(again[4]) and float(first[5]) == float(again[5])


@pytest.mark.cuda
def test_solve_launches_the_kernel_every_iteration(cuda_device):
    """Small solve on the card: one kernel launch per iteration, and the
    err_hist of the float32 CUDA run within rtol 1e-3 of a float64 CPU run
    from the same init (f32 rounding over 15 iterations)."""
    rng = np.random.default_rng(0)
    shape = (20, 16, 24)
    y = torch.from_numpy(rng.standard_normal(shape) * 10)
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=15, tol=0.0)
    init = init_factors(torch.Generator().manual_seed(0), shape, cfg.rank, torch.float32)
    hopper_kernels.reset_launch_counts()
    gpu = tritd_admm(y.float().to(cuda_device), cfg, init=init)
    assert hopper_kernels.LAUNCHES["elementwise_block[f32]"] == gpu.n_iters == 15
    cpu = tritd_admm(y, dataclasses.replace(cfg, dtype="float64"), init=init)
    np.testing.assert_allclose(gpu.err_hist.cpu().numpy(), cpu.err_hist.numpy(), rtol=1e-3)


# (D, storage, T', with T') of the narrow variants, by the solver path
# that produces them
NARROW = {
    "storage": (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
    "masked_storage": (None, torch.bfloat16, torch.bfloat16, False),
    "einsum_only": (None, None, torch.bfloat16, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(NARROW))
@pytest.mark.parametrize("compute", [torch.float32, torch.float64], ids=["c32", "c64"])
@pytest.mark.parametrize("shape", [(17, 23, 31), (1, 1, 1), (100, 100, 500)])
def test_narrow_kernel_matches_plain(cuda_device, shape, compute, case):
    d_dt, s_dt, t_dt, with_t = NARROW[case]
    d_dt, s_dt = d_dt or compute, s_dt or compute
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    raw = [torch.randn(shape, generator=gen, dtype=compute, device=cuda_device) * 3 for _ in range(5)]
    args = [raw[0].to(d_dt), raw[1], *(x.to(s_dt) for x in raw[2:])]
    variant = hopper_kernels.kernel_variant(*args, t_dtype=t_dt)
    mu_next = MU_NEXT if with_t else None
    before = hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"]
    got = hopper_kernels.elementwise_block(*args, *SCALARS, mu_l_next=mu_next, t_dtype=t_dt)
    torch.cuda.synchronize()
    assert hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"] == before + 1
    want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next, compute_dtype=compute,
                                       store_dtype=s_dt, t_dtype=t_dt)
    for i in (0, 1, 2, 3):
        assert got[i].dtype == s_dt and got[i].shape == shape
    hopper_kernels.check_narrow_against_plain(args, got, want, mu_next)
    for i in (4, 5):
        assert got[i].dtype == compute
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
    if with_t:
        assert got[6].dtype == t_dt
    else:
        assert got[6] is None


@pytest.mark.cuda
@pytest.mark.parametrize("fields, masked, variant", [
    (dict(storage_dtype="bfloat16"), False, "c32_dbf16_sbf16_tbf16"),
    (dict(storage_dtype="bfloat16"), True, "c32_d32_sbf16_tbf16"),
    (dict(einsum_dtype="bfloat16"), False, "c32_d32_s32_tbf16"),
], ids=["storage", "storage_masked", "einsum"])
def test_narrow_solve_launches_its_variant(cuda_device, fields, masked, variant):
    """A narrow solve on the card launches its kernel variant once per
    iteration, and lands within 0.03 RRE of the float32 run."""
    rng = np.random.default_rng(2)
    shape = (20, 16, 24)
    a, b, c = (rng.standard_normal(s) for s in ((20, 2, 2), (2, 16, 2), (2, 2, 24)))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = torch.from_numpy(x / np.sqrt(np.mean(x**2))).float().to(cuda_device)
    mask = torch.from_numpy(rng.random(shape) > 0.2).to(cuda_device) if masked else None
    y = torch.where(mask, x, torch.zeros_like(x)) if masked else x
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=2, max_iter=40, tol=0.0, masked=masked)
    init = init_factors(torch.Generator().manual_seed(0), shape, 2, torch.float32)
    hopper_kernels.reset_launch_counts()
    narrow = tritd_admm(y, dataclasses.replace(cfg, **fields), mask=mask, origin=x, init=init)
    assert hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"] == narrow.n_iters == 40
    assert narrow.o.dtype == torch.float32 and torch.isfinite(narrow.err_hist).all()
    wide = tritd_admm(y, cfg, mask=mask, origin=x, init=init)
    assert abs(float(narrow.rre_hist[-1]) - float(wide.rre_hist[-1])) < 0.03


def _spectrum_matrix(p, q, spectrum, seed=0):
    rng = np.random.default_rng(seed)
    k = min(p, q)
    u = np.linalg.qr(rng.standard_normal((p, k)))[0]
    v = np.linalg.qr(rng.standard_normal((q, k)))[0]
    s = np.zeros(k)
    s[: len(spectrum)] = spectrum
    return torch.from_numpy((u * s) @ v.T)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 2000), (2000, 64), (300, 300)], ids=str)
def test_svt_routes_on_the_card(cuda_device, shape):
    """gram, the randomized route (20 survivors in a budget of 32) and a
    warm refresh against the float64 SVD route on the CPU; the spectrum
    stays away from tau and tau + 1."""
    m64 = _spectrum_matrix(*shape, np.concatenate([np.linspace(60.0, 12.0, 20), np.linspace(1.5, 0.1, 20)]))
    want = svt_ops.svt_ref_compat(m64, 2.0, "svd")
    m = m64.float().to(cuda_device)
    atol = 1e-4 * float(torch.linalg.vector_norm(m64))
    eye = torch.eye(min(shape), device=cuda_device)
    outs = {
        "svd": svt_ops.svt_ref_compat(m, 2.0, "svd"),
        "gram": svt_ops.svt_ref_compat(m, 2.0, "gram"),
        "lowrank:32": svt_ops.svt_ref_compat(m, 2.0, "lowrank:32"),
        "warm refresh": svt_ops.svt_ref_compat_warm(m, 2.0, eye, True)[0],
        "plain gram": None,
    }
    for name, got in outs.items():
        if got is None:
            got, ref = svt_ops.svt(m, 2.0, "gram"), svt_ops.svt(m64, 2.0, "svd")
        else:
            ref = want
        assert got.device.type == "cuda" and got.dtype == torch.float32, name
        torch.testing.assert_close(got.cpu().double(), ref, rtol=0, atol=atol, msg=lambda s: f"{name}: {s}")
    assert torch.equal(outs["lowrank:32"], svt_ops.svt_ref_compat(m, 2.0, "lowrank:32"))  # a fixed sketch


@pytest.mark.cuda
@pytest.mark.parametrize("svt_method", ["svd", "gram", "warm:4"])
@pytest.mark.parametrize("method", ["ttnn", "ring", "fctn"])
def test_svt_baselines_on_the_card(cuda_device, method, svt_method):
    spec = DatasetSpec("tiny", "traffic", "T", (24, 20, 32), fctn_subdim=4, sofia_period=4)
    x = torch.from_numpy(synthetic_traffic(spec, np.random.default_rng(1)))
    mask = torch.from_numpy(np.random.default_rng(2).random(spec.shape) > 0.1)
    y = torch.where(mask, x, torch.zeros_like(x))
    gen = torch.Generator().manual_seed(0)
    _xh, _o, want = run_method(method, y, x, mask, spec, gen, 10, svt_method=svt_method)
    xh, o, got = run_method(method, y.float().to(cuda_device), x.float().to(cuda_device),
                            mask.to(cuda_device), spec, gen, 10, svt_method=svt_method)
    assert xh.device.type == o.device.type == "cuda" and xh.dtype == torch.float32
    assert got.shape == (10,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.cuda
def test_sofia_and_the_other_baselines_on_the_card(cuda_device):
    from tritd_tpu_torch.baselines import rnc_fctn, sofia_init, trpca_snn, trpca_tnn

    spec = DatasetSpec("tiny", "traffic", "T", (16, 14, 28), fctn_subdim=4, sofia_period=7)
    x = torch.from_numpy(synthetic_traffic(spec, np.random.default_rng(3)))
    xc = x.float().to(cuda_device)
    ones = torch.ones(spec.shape, dtype=torch.bool)
    init = tuple(torch.rand((n, 3), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
                 for n in spec.shape)
    _u, want_x, _o, want = sofia_init(x, ones, 3, 7, origin=x, max_epoch=4, u_init=init, dtype=torch.float64)
    u, xh, o, got = sofia_init(xc, ones.to(cuda_device), 3, 7, origin=xc, max_epoch=4, u_init=init)
    assert xh.device.type == o.device.type == u[2].device.type == "cuda"
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for fn, kw in ((trpca_tnn, dict(origin=xc, mu=1e-3)), (trpca_snn, dict(mu=1e-3))):
        low, sparse, hist = fn(xc, max_iter=8, **kw)
        ref = fn(x, max_iter=8, **{k: (x if k == "origin" else v) for k, v in kw.items()})[2]
        assert low.device.type == sparse.device.type == "cuda"
        np.testing.assert_allclose(hist.cpu().numpy(), ref.numpy(), rtol=1e-3)
    f4 = torch.rand((8, 7, 6, 5), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    om = torch.rand((8, 7, 6, 5), generator=torch.Generator().manual_seed(3)) > 0.2
    # one seed draws other numbers in float32 than in float64: hand both runs the same factors
    cores = [torch.rand(shape, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
             for shape in ((8, 2, 2, 2), (2, 7, 2, 2), (2, 2, 6, 2), (2, 2, 2, 5))]
    draws = dict(init=cores, pad_values=[0.25, 0.5, 0.75, 0.35, 0.65, 0.45])
    ref = rnc_fctn(f4, 0.1, om, origin=f4, max_iter=12, **draws)
    out = rnc_fctn(f4.float().to(cuda_device), 0.1, om.to(cuda_device), origin=f4.float().to(cuda_device),
                   max_iter=12, **draws)
    assert out[0].device.type == "cuda" and out[4] == ref[4]
    np.testing.assert_allclose(out[3], ref[3], rtol=1e-3)


@pytest.mark.cuda
def test_host_proximal_library_builds_beside_the_kernels(cuda_device):
    assert native.available()
    np.testing.assert_allclose(native.soft_threshold(np.array([-3.0, 0.5, 2.0]), 1.0), [-2.0, 0.0, 1.0])
