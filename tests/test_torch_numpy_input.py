"""PyTorch port, where the metrics, the functional `ops` surface,
`baselines.prox_tnn`, the flat `ops.elementwise_block`, `interop`'s six
`*_from_numpy`, `baselines.sofia_stream` and `solvers.init_factors` put
their input, by the entry points' rule (`ops.kruskal.on_input_device`,
`input_device`): a tensor keeps its device unless `device` names another;
numpy goes to the card, as the reference places an array on its
accelerator, and raises `RuntimeError` without CUDA; `device="cpu"` runs
the plain path. Each entry of `tests/torch_numpy_entries.py` is held three
ways: numpy without CUDA raises (CUDA is made unavailable for the test, so
it also holds on a machine with a card); numpy with `device="cpu"` gives
bitwise what the call on CPU tensors gives; CPU tensors give CPU results.
The same entries run on the card in `chip_smoke.py` phase 20. Also: every
public function of the repaired modules is an entry or is named in
`NO_DATA_TENSOR`, and the functions that returned numpy for numpy input
(`khatrirao`, `ktensor_full`, `sumtensor_full`) return tensors."""

import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_numpy_entries import ENTRIES, FAC, NO_DATA_TENSOR, X  # noqa: E402

from tritd_tpu_torch import interop, metrics, ops  # noqa: E402
from tritd_tpu_torch.solvers import init_factors  # noqa: E402

NAMES = sorted(ENTRIES)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(a):
    return a


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(out) -> list:
    """The outputs' tensors and arrays, and the plain values beside them."""
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [leaf for item in out for leaf in _leaves(item)]
    return [out]


def _same(got, want, name):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), name
    for a, b in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(torch.nan_to_num(a, nan=0.5), torch.nan_to_num(b, nan=0.5)), name
            assert torch.equal(a.isnan(), b.isnan()) if a.is_floating_point() else True, name
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b or (a != a and b != b), (name, a, b)


@pytest.mark.parametrize("name", NAMES)
def test_numpy_input_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRIES[name](_numpy)


@pytest.mark.parametrize("name", NAMES)
def test_numpy_on_the_cpu_is_the_tensor_call(name):
    got = ENTRIES[name](_numpy, device="cpu")
    want = ENTRIES[name](_tensor)
    _same(got, want, name)
    assert all(x.device.type == "cpu" for x in _leaves(got) if isinstance(x, torch.Tensor))


@pytest.mark.parametrize("name", NAMES)
def test_a_tensor_keeps_its_device(name, monkeypatch):
    """CPU tensors run on the CPU with no `device`, and need no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ENTRIES[name](_tensor)
    assert all(x.device.type == "cpu" for x in _leaves(out) if isinstance(x, torch.Tensor)), name


def test_init_factors_draws_on_the_cpu_and_goes_to_the_card(monkeypatch):
    """No input to follow: the card by default, `RuntimeError` without
    CUDA; one seed gives one draw wherever it is put."""
    want = [torch.randn(s, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
            for s in ((4, 2, 2),)]
    got = init_factors(torch.Generator().manual_seed(3), (4, 5, 6), 2, torch.float64, device="cpu")
    assert all(u.device.type == "cpu" for u in got) and torch.equal(got[0], want[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_factors(torch.Generator().manual_seed(3), (4, 5, 6), 2, torch.float64)


def test_functions_that_returned_numpy_return_tensors():
    for out in (ops.khatrirao(FAC[0], FAC[1], device="cpu"), ops.ktensor_full(FAC, device="cpu"),
                ops.sumtensor_full([X, X], device="cpu")):
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float64


def test_a_main_tensor_takes_numpy_beside_it_to_its_device():
    """The first data argument given is the main input; numpy beside a
    tensor follows it, with no card needed."""
    got = metrics.rre(torch.from_numpy(X), X + 1.0)
    assert got.device.type == "cpu"
    assert torch.equal(got, metrics.rre(torch.from_numpy(X), torch.from_numpy(X + 1.0)))


def test_every_public_function_of_the_repaired_modules_is_held():
    """Each public function of the repaired modules is an entry of
    `ENTRIES` (by its name) or is named in `NO_DATA_TENSOR`."""
    modules = ["ops.fold", "ops.shrinkage", "ops.svt", "ops.prox", "ops.kruskal", "ops.decomp", "ops.tenutils",
               "ops.sparse", "ops.symmetric", "ops.cp_variants", "metrics.recon", "metrics.image"]
    held = {name.split(".")[-1] for name in ENTRIES} | {"elementwise_block"}
    missing = []
    for mod_name in modules:
        mod = importlib.import_module(f"tritd_tpu_torch.{mod_name}")
        for fn_name, fn in vars(mod).items():
            if fn_name.startswith("_") or not inspect.isfunction(fn) or fn.__module__ != mod.__name__:
                continue
            if fn_name not in held and f"{mod_name}.{fn_name}" not in NO_DATA_TENSOR:
                missing.append(f"{mod_name}.{fn_name}")
    assert not missing, missing
    for fn_name in ("factors_from_numpy", "tensor_from_numpy", "state_from_numpy", "ktensor_from_numpy",
                    "ttensor_from_numpy", "sptensor_from_numpy"):
        assert f"interop.{fn_name}" in ENTRIES
        assert inspect.signature(getattr(interop, fn_name)).parameters["device"].default is None
