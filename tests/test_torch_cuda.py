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
D - O' + Y_L'/muL_next from the kernel's own stored O' and Y_L'."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
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
