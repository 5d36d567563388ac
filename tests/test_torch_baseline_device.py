"""PyTorch port, where the baselines and the sharded solve over a bare process
group put their input, by the solvers' rule (`ops.kruskal.solver_input`): a
tensor keeps its device unless `device` names another; anything else (a
numpy array) goes to the card, and raises without CUDA, as the reference
places an array on its accelerator; `device="cpu"` runs the plain path, and
the mask, origin and init arguments follow the main input. Here, without a
card, the numpy cases raise; `tests/test_torch_cuda.py` runs them on one.

The entry points that refused numpy before they took `device` are also held,
from numpy, to the JAX package's same call at float64 on the CPU, with the
tolerances of `tests/test_torch_baselines.py`: err_hist rtol 1e-7, final
tensors atol 1e-7 of their norm; `rnc_fctn` from the factors and padding
scalars the JAX package draws."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from torch_baseline_entries import (  # noqa: E402
    ENTRIES,
    F4,
    F4_OMEGA,
    F4_TRUTH,
    IND4,
    MASK,
    RAISED_ON_NUMPY,
    SUBDIM,
    X,
    X4,
    Y,
    Y4,
    devices,
    flat,
)

RTOL = 1e-7
jttnn = importlib.import_module("tritd_tpu.baselines.ttnn")
jtrpca = importlib.import_module("tritd_tpu.baselines.trpca")
jfctn = importlib.import_module("tritd_tpu.baselines.rc_fctn")
jrnc = importlib.import_module("tritd_tpu.baselines.rnc_fctn")
rtrc = importlib.import_module("tritd_tpu_torch.baselines.rtrc")
rnc_fctn = importlib.import_module("tritd_tpu_torch.baselines.rnc_fctn")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The default process group, one gloo rank in this process: the bare
    group `tritd_admm_sharded` is given."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _numpy(a):
    return a


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(out) -> list:
    """The outputs' tensors and arrays, and the plain numbers beside them."""
    if isinstance(out, (tuple, list)):
        return [leaf for item in out for leaf in _leaves(item)]
    return [out] if isinstance(out, (torch.Tensor, np.ndarray, int, float)) else []


@pytest.mark.parametrize("name", list(ENTRIES))
def test_numpy_input_without_a_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: numpy input goes to the card (tests/test_torch_cuda.py)")
    with pytest.raises(RuntimeError, match='CUDA is not available; pass device="cpu"'):
        ENTRIES[name](_numpy)


@pytest.mark.parametrize("name", list(ENTRIES))
def test_numpy_input_on_the_cpu_when_asked(name):
    got = _leaves(ENTRIES[name](_numpy, device="cpu"))
    want = _leaves(ENTRIES[name](_tensor))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert type(g) is type(w)
        if isinstance(g, torch.Tensor):
            assert g.device.type == "cpu" and g.dtype == w.dtype
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(ENTRIES))
def test_a_tensor_keeps_its_device(name):
    out = ENTRIES[name](_tensor)
    assert devices(out) <= {"cpu"} and flat(out)


def test_the_freedom_ratio_cache_hits_for_numpy_and_tensor_alike(monkeypatch):
    """The host ranks computed once from numpy serve a later solve of the same
    data given as a tensor on the same device."""
    rtrc._FREEDOM_RATIO_CACHE.clear()
    first = rtrc.precompute_freedom_ratio(Y, MASK, device="cpu")

    def no_rank(*_a, **_k):
        raise AssertionError("matrix_rank ran again: the cache missed")

    monkeypatch.setattr(np.linalg, "matrix_rank", no_rank)
    assert rtrc.precompute_freedom_ratio(_tensor(Y), _tensor(MASK)) is first
    rtrc.rtrc(_tensor(Y), _tensor(MASK), max_iter=1)
    rtrc.rtrc(Y, MASK, max_iter=1, device="cpu")
    assert len(rtrc._FREEDOM_RATIO_CACHE) == 1


def _rnc_draws():
    """The JAX solver's factors and padding scalars from PRNGKey(3), as
    tests/test_torch_baselines.py draws them."""
    key = jax.random.PRNGKey(3)
    init, _ = jrnc._init_factors(key, F4.shape, np.triu(np.full((4, 4), 2), 1), jnp.float64)
    pads, k = [], key
    for _ in range(8):
        k, sub = jax.random.split(k)
        pads.append(float(jax.random.uniform(sub, ())))
    return [np.array(g) for g in init], pads


def _jax_and_port(name):
    """(JAX's outputs, the port's from numpy on the CPU): (hist, tensors...)."""
    j = jnp.asarray
    if name == "tt_trpca":
        jz, js, jhist, _ = jttnn.tt_trpca(j(Y), origin=j(X), max_iter=4, svt_method="gram")
        z, s, hist, _ = ENTRIES[name](_numpy, device="cpu")
        return (jhist, jz, js), (hist, z, s)
    if name in ("trpca_tnn", "trpca_snn"):
        kw = dict(origin=j(X)) if name == "trpca_tnn" else dict(alpha=(1.0, 0.8, 1.2))
        jl, js, jhist = getattr(jtrpca, name)(j(Y), mu=1e-3, max_iter=4, **kw)
        l, s, hist = ENTRIES[name](_numpy, device="cpu")
        return (jhist, jl, js), (hist, l, s)
    if name == "rc_fctn":
        jx, js, jhist = jfctn.rc_fctn(j(Y4), 1.8, j(IND4), origin=j(X4), f=0.7, max_iter=4, svt_method="gram")
        xh, s, hist = ENTRIES[name](_numpy, device="cpu")
        return (jhist, jx, js), (hist, xh, s)
    if name.startswith("rc_fctn_driver_"):
        jx, js, jhist = getattr(jfctn, name)(j(Y), j(MASK), SUBDIM, origin=j(X), max_iter=4, svt_method="gram")
        xh, s, hist = ENTRIES[name](_numpy, device="cpu")
        return (jhist, jx, js), (hist, xh, s)
    assert name == "rnc_fctn"
    init, pads = _rnc_draws()
    jx, _jgs, je, jhist, jn = jrnc.rnc_fctn(j(F4), 0.3, j(F4_OMEGA), origin=j(F4_TRUTH), max_iter=30,
                                            key=jax.random.PRNGKey(3))
    x, _gs, e, hist, n = rnc_fctn.rnc_fctn(F4, 0.3, F4_OMEGA, origin=F4_TRUTH, max_iter=30, init=init,
                                           pad_values=pads, device="cpu")
    assert n == jn
    return (jhist, jx, je), (hist, x, e)


@pytest.mark.parametrize("name", RAISED_ON_NUMPY)
def test_numpy_input_matches_jax(name):
    with jax.enable_x64(True):
        want, got = _jax_and_port(name)
        want = [np.asarray(w) for w in want]
    hist, *tensors = got
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" and t.dtype == torch.float64 for t in tensors)
    hist = np.asarray(hist)
    assert hist.shape == want[0].shape and np.isfinite(want[0]).all()
    np.testing.assert_allclose(hist, want[0], rtol=RTOL)
    for t, w in zip(tensors, want[1:]):
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=RTOL * max(np.linalg.norm(w), 1.0))
