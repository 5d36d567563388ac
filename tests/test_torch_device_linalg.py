"""PyTorch port: `ops/device_linalg.py` on the CPU, where its eigh and SVD
are the plain versions (`torch.linalg`), bitwise; its choice of cuSOLVER
driver by size, which decides what a CUDA graph can capture; and the
ctypes declarations of `csrc/device_linalg.cu`'s entry points against the
source. The drivers themselves run on the card only
(`tests/test_torch_cuda.py`, smoke phase 9).
"""

import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tritd_tpu_torch.ops import device_linalg  # noqa: E402
from tritd_tpu_torch.runtime import build, kernels  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gram(n: int, dtype, seed: int = 0, rank: int | None = None) -> torch.Tensor:
    m = np.random.default_rng(seed).standard_normal((n, rank or 2 * n)) * np.linspace(1.0, 30.0, rank or 2 * n)
    return torch.from_numpy(m @ m.T).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cpu_eigh_and_svd_are_torch_linalg_bitwise(dtype):
    a = _gram(30, dtype, seed=5)
    for got, want in zip(device_linalg.eigh(a), torch.linalg.eigh(a)):
        assert torch.equal(got, want)
    m = torch.from_numpy(np.random.default_rng(6).standard_normal((12, 40))).to(dtype)
    for got, want in zip(device_linalg.svd(m), torch.linalg.svd(m, full_matrices=False)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n, want", [(1, "xsyevbatched"), (100, "xsyevbatched"), (500, "xsyevbatched"),
                                     (512, "xsyevbatched"), (513, "xsyevd"), (1000, "xsyevd"), (4800, "xsyevd")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_driver_choice_follows_the_probe(n, want, dtype):
    """An eigh goes to cuSOLVER's batched syev, which a CUDA graph captures,
    up to n = 512, and to Xsyevd, torch.linalg.eigh's driver there (its
    bits), past it, where no cuSOLVER driver captures; the SVD at the
    baselines' taxi cuts takes the hand-written Jacobi SVD, which a graph
    captures, and gesvdj (torch's) past its limit, which none does."""
    assert device_linalg.eigh_driver(n, dtype) == want
    assert device_linalg.eigh_captures(n) is (want == "xsyevbatched")
    assert device_linalg.XSYEV_BATCHED_MAX_N == 512
    if n > 512:
        assert device_linalg.torch_eigh_driver(n, dtype) == want
    assert device_linalg.svd_driver(100, 50000, dtype) == "jacobi"
    assert device_linalg.svd_driver(4800, 4800, dtype) == "gesvdj"
    assert device_linalg.torch_eigh_driver(500, torch.float32) == "syevj"
    assert device_linalg.torch_eigh_driver(500, torch.float64) == "xsyevd"
    assert device_linalg.EIGH_DRIVERS == ("xsyevbatched", "xsyevd") and device_linalg.SVD_DRIVERS == ("jacobi", "gesvdj")


def _c_parameters() -> dict:
    """The parameter count of each extern "C" tritd_* function of the
    source."""
    src = (build.SRC_DIR / "device_linalg.cu").read_text()
    return {fn: 0 if params.strip() in ("", "void") else params.count(",") + 1
            for fn, params in re.findall(r"^int (tritd_\w+)\(([^)]*)\)", src, re.M)}


def test_binding_declares_every_c_entry_with_its_parameters():
    counts = _c_parameters()
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in counts})
    kernels._bind_linalg(lib)
    assert set(counts) == {"tritd_linalg_version", "tritd_linalg_provider", "tritd_linalg_create",
                           "tritd_gesvdj_info_create", "tritd_xsyevd_buffer", "tritd_xsyevd",
                           "tritd_xsyevbatched_buffer", "tritd_xsyevbatched", "tritd_gesvdj_buffer", "tritd_gesvdj"}
    for name, n in counts.items():
        assert len(getattr(lib, name).argtypes) == n, name
    assert "-lcusolver" in build.link_flags() and build.LINK_LIBS == ("-lcusolver",)
