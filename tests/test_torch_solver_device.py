"""PyTorch port, where the solvers put their input: a tensor keeps its
device; anything else (a numpy array) goes to `ops.kruskal.default_device`,
the card, and raises without CUDA, as the reference places an array on its
accelerator; `device="cpu"` runs the plain path. The same for
`utils.checkpoint.load_state`, which follows a tensor `d`. Here, without a
card, the numpy cases raise; `tests/test_torch_cuda.py` runs them on one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tritd_tpu_torch.solvers import (  # noqa: E402
    OutlierConfig,
    TriTDConfig,
    tritd_admm,
    tritd_admm_checkpointed,
    tritd_admm_outlier,
    tritd_als,
    tritd_mals,
)
from tritd_tpu_torch.utils import checkpoint  # noqa: E402

SHAPE = (6, 5, 7)
CFG = TriTDConfig(rank=2, max_iter=3, tol=0.0, dtype="float64")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    return np.random.default_rng(0).standard_normal(SHAPE)


def _without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: numpy input goes to the card (tests/test_torch_cuda.py)")


SOLVERS = {
    "tritd_admm": lambda d, tmp, **kw: tritd_admm(d, CFG, **kw),
    "tritd_admm_checkpointed": lambda d, tmp, **kw: tritd_admm_checkpointed(d, CFG, str(tmp), every=2, **kw),
    "tritd_admm_outlier": lambda d, tmp, **kw: tritd_admm_outlier(d, OutlierConfig(rank=2, max_iter=3), **kw),
    "tritd_als": lambda d, tmp, **kw: tritd_als(d, CFG, **kw),
    "tritd_mals": lambda d, tmp, **kw: tritd_mals(d, CFG, **kw),
}


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_numpy_input_without_a_device_raises_without_cuda(solver, tmp_path):
    _without_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SOLVERS[solver](_data(), tmp_path)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_numpy_input_on_the_cpu_when_asked(solver, tmp_path):
    d = _data()
    got = SOLVERS[solver](d, tmp_path / "numpy", device="cpu")
    want = SOLVERS[solver](torch.from_numpy(d), tmp_path / "tensor")
    assert got.a.device.type == "cpu" and got.err_hist.device.type == "cpu"
    for f in ("a", "b", "c", "o", "err_hist"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_a_tensor_keeps_its_device(solver, tmp_path):
    got = SOLVERS[solver](torch.from_numpy(_data()), tmp_path)
    assert got.a.device.type == "cpu" and got.o.device.type == "cpu"


def test_load_state_follows_d_or_goes_to_the_card(tmp_path):
    d = torch.from_numpy(_data())
    tritd_admm_checkpointed(d, CFG, str(tmp_path), every=3)
    path = str(tmp_path / "step_000003.npz")
    assert checkpoint.load_state(path, d=d).o.device.type == "cpu"  # d's device
    assert checkpoint.load_state(path, device="cpu").a.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            checkpoint.load_state(path)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            checkpoint.load_state(path, d=d.numpy())
