"""PyTorch port, fused elementwise ADMM block: the plain PyTorch version held
against both JAX routes of tritd_tpu.ops.pallas_kernels (the jnp fusion and
the Pallas kernel in interpret mode), the wrapper's input checks and build
errors. The kernel itself is held against the plain version on the card by
test_torch_cuda.py.

Tolerances: float32 rtol 1e-6 (atol 1e-6) on tensors and 1e-5 on the two
norms, as in test_pallas.py — the elementwise arithmetic rounds alike up to
an ulp or two, while the sums are taken in another order. float64: rtol
1e-12 everywhere."""

import importlib
import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu.ops.pallas_kernels import elementwise_block as j_block  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops.hopper_kernels import _block_torch, elementwise_block  # noqa: E402
from tritd_tpu_torch.runtime import build, kernels  # noqa: E402

SHAPES = [(17, 23, 31), (8, 128, 4), (5, 7, 11)]
SCALARS = (0.5, 0.7, 1.8)
MU_NEXT = 0.625
TOL = {  # dtype: (tensor rtol, norm rtol)
    "float32": (1e-6, 1e-5),
    "float64": (1e-12, 1e-12),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(5)]


def _jax_block(arrays, use_pallas):
    out = j_block(*map(jnp.asarray, arrays), *SCALARS,
                  use_pallas=use_pallas, interpret=use_pallas)
    return [np.asarray(v) for v in out]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_block_matches_jax(shape, use_pallas, dtype):
    arrays = _inputs(shape, dtype)
    with jax.enable_x64(dtype == "float64"):
        want = _jax_block(arrays, use_pallas)
    got = elementwise_block(*map(torch.from_numpy, arrays), *SCALARS, mu_l_next=MU_NEXT)
    rtol, nrtol = TOL[dtype]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=rtol)
    for g, w in zip(got[4:6], want[4:6]):
        np.testing.assert_allclose(float(g), float(w), rtol=nrtol)
    # T' = D - O' + Y_L'/muL_next, the solver's carried target (admm.py:156-163)
    d, _l, _e, _yl, _yo = arrays
    t_want = d - want[0] + want[2] / np.asarray(MU_NEXT, dtype)
    np.testing.assert_allclose(got[6].numpy(), t_want, rtol=rtol, atol=rtol)


def test_block_without_mu_next_skips_t():
    arrays = map(torch.from_numpy, _inputs((4, 5, 6), "float32"))
    assert elementwise_block(*arrays, *SCALARS)[6] is None


def test_block_propagates_nan():
    arrays = _inputs((3, 4, 5), "float64")
    arrays[0][0, 0, 0] = np.nan
    got = _block_torch(*map(torch.from_numpy, arrays), *SCALARS)
    assert np.isnan(got[0][0, 0, 0].item()) and np.isnan(got[1][0, 0, 0].item())
    assert np.isnan(float(got[4]))


def test_kernel_wrapper_checks_inputs_before_building():
    good = [torch.zeros(2, 3, 4) for _ in range(5)]
    with pytest.raises(TypeError, match="float32 or float64"):
        hopper_kernels._block_cuda(*[x.half() for x in good], *SCALARS)
    with pytest.raises(TypeError, match="mixed dtypes"):
        hopper_kernels._block_cuda(*good[:2], good[2].double(), *good[3:], *SCALARS)
    with pytest.raises(ValueError, match="contiguous"):
        hopper_kernels._block_cuda(good[0], good[1].transpose(0, 2).contiguous().transpose(0, 2),
                                   *good[2:], *SCALARS)
    with pytest.raises(ValueError, match="shapes"):
        hopper_kernels._block_cuda(good[0], torch.zeros(4, 3, 2), *good[2:], *SCALARS)
    with pytest.raises(ValueError, match="CUDA device"):
        hopper_kernels._block_cuda(*good, *SCALARS)
    assert kernels.library.cache_info().currsize == 0


def test_block_rejects_other_devices():
    meta = [torch.empty(2, 2, 2, device="meta") for _ in range(5)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        elementwise_block(*meta, *SCALARS)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()


def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a kernel refused' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="sm_90a kernel refused"):
        build.build()
    assert os.listdir(tmp_path / "_build") == []  # no half-written library left


def test_library_name_follows_sources_and_flags(monkeypatch):
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path() != path


def test_importing_the_port_builds_nothing():
    for mod in ("tritd_tpu_torch.solvers.admm", "tritd_tpu_torch.cli.run_completion"):
        importlib.import_module(mod)
    assert kernels.library.cache_info().currsize == 0
