"""PyTorch port, the device form of the solve loops that are not
`tritd_admm`'s: `tritd_admm_checkpointed`'s segments (one `_AdmmLoop`
advanced segment by segment, one iteration a block), `tritd_admm_outlier`
and `tritd_als`/`tritd_mals` (the same loop object, `admm._DeviceLoop`).
On a CUDA device each block after the first is one replay of a captured
graph; here, on the CPU, the same blocks run eagerly (`graphs=False`; the
eager loop is `graphs=None`), and are held:

  * to the eager loop (host counter and stop flag) bitwise over whole
    solves, `n_iters` included, and for the checkpointed solve every saved
    checkpoint too;
  * to themselves across a resume: a device-form resume from a mid-run save
    is bitwise a run that never stopped;
  * to the JAX package's solvers at the tolerances of
    `test_torch_solvers.py`: float64, err_hist rtol 1e-8, factors rtol 1e-6
    (the same programs up to summation order).

The graph route's control flow runs here too, with a stand-in for the CUDA
graph that replays the captured block's Python (`_FakeGraph`): a loop that
outlives its segments captures nothing after its second block, and its
results are the eager loop's. Its synchronizing calls and the real
captures are held on the card (`tests/test_torch_cuda.py`).
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu.solvers import OutlierConfig as JOutlierConfig  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers import tritd_admm_checkpointed as j_checkpointed  # noqa: E402
from tritd_tpu.solvers import tritd_admm_outlier as j_outlier  # noqa: E402
from tritd_tpu.solvers import tritd_als as j_als  # noqa: E402
from tritd_tpu.solvers import tritd_mals as j_mals  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.solvers import (  # noqa: E402
    OutlierConfig,
    TriTDConfig,
    admm,
    als,
    checkpointed,
    outlier,
    tritd_admm,
    tritd_admm_checkpointed,
    tritd_admm_outlier,
    tritd_als,
    tritd_mals,
)
from tritd_tpu_torch.utils.config import COMPLETION_TRITD, VIDEO_TRITD  # noqa: E402

SHAPE = (12, 10, 14)
RANK = 3
RESULT_FIELDS = ("a", "b", "c", "o", "e", "err_hist", "rre_hist")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, spikes=0.03):
    """Low-TriTD-rank truth + noise + sparse spikes."""
    rng = np.random.default_rng(seed)
    n1, n2, n3 = SHAPE
    a = rng.standard_normal((n1, RANK, RANK))
    b = rng.standard_normal((RANK, n2, RANK))
    c = rng.standard_normal((RANK, RANK, n3))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = 10.0 * x / np.sqrt(np.mean(x**2)) + 0.05 * rng.standard_normal(SHAPE)
    return x + (rng.random(SHAPE) < spikes) * 20.0


def _init(dtype, seed=0):
    """Standard-normal factors drawn with numpy."""
    rng = np.random.default_rng(seed)
    n1, n2, n3 = SHAPE
    return [rng.standard_normal(s).astype(dtype) for s in ((n1, RANK, RANK), (RANK, n2, RANK), (RANK, RANK, n3))]


def _tensor(x: np.ndarray, cfg) -> torch.Tensor:
    """`x` as the private solve functions take it: a tensor in cfg.dtype."""
    return torch.from_numpy(x).to(cfg.torch_dtype())


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)))


def _assert_same_result(got, want, fields=RESULT_FIELDS):
    assert got.n_iters == want.n_iters and type(got.n_iters) is int
    for f in fields:
        assert _same_bits(getattr(got, f), getattr(want, f)), f


def _checkpoints(path) -> dict:
    """step file -> {array name: array} of every checkpoint in `path`."""
    out = {}
    for name in sorted(p for p in os.listdir(path) if p.startswith("step_")):
        with np.load(os.path.join(path, name)) as f:
            out[name] = {k: f[k] for k in f.files}
    return out


def _assert_same_checkpoints(got_dir, want_dir):
    got, want = _checkpoints(got_dir), _checkpoints(want_dir)
    assert list(got) == list(want) and got
    for step in want:
        assert sorted(got[step]) == sorted(want[step]), step
        for name, w in want[step].items():
            g = got[step][name]
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), (step, name)


# --- the checkpointed segments ----------------------------------------------

CKPT_DTYPES = {"f32": dict(), "f64": dict(dtype="float64"), "bf16_storage": dict(storage_dtype="bfloat16")}


def _ckpt_cfg(case, tol):
    return dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=30, tol=tol, **CKPT_DTYPES[case])


def _ckpt_solve(cfg, d, path, every, graphs, init):
    return checkpointed._solve(_tensor(d, cfg), cfg, str(path), every, init, None, True, graphs)


@pytest.mark.parametrize("tol", [0.0, 2e-2], ids=["tol0", "early_stop"])
@pytest.mark.parametrize("every", [1, 7, 25])
@pytest.mark.parametrize("case", list(CKPT_DTYPES))
def test_checkpointed_device_form_is_the_eager_loop_bitwise(tmp_path, case, every, tol):
    """The whole call: the result and every checkpoint it saved in the same
    bits; with tol 2e-2 both stop early, inside a segment."""
    cfg = _ckpt_cfg(case, tol)
    d, init = _data(), _init(cfg.np_dtype().type)
    eager = _ckpt_solve(cfg, d, tmp_path / "eager", every, None, init)
    device = _ckpt_solve(cfg, d, tmp_path / "device", every, False, init)
    _assert_same_result(device, eager)
    if tol:
        assert eager.n_iters < cfg.max_iter
    else:
        assert eager.n_iters == cfg.max_iter
    _assert_same_checkpoints(tmp_path / "device", tmp_path / "eager")


@pytest.mark.parametrize("case", ["f32", "bf16_storage"])
def test_checkpointed_device_form_resumes_bitwise(tmp_path, case):
    """A device-form run stopped after its step-14 save (max_iter 14) and
    resumed by a new loop from that checkpoint ends in the bits of a
    device-form run that never stopped."""
    cfg = _ckpt_cfg(case, 0.0)
    d, init = _data(1), _init(np.float32, seed=1)
    whole = _ckpt_solve(cfg, d, tmp_path / "whole", 7, False, init)
    _ckpt_solve(dataclasses.replace(cfg, max_iter=14), d, tmp_path / "cut", 7, False, init)
    assert sorted(os.listdir(tmp_path / "cut")) == ["step_000007.npz", "step_000014.npz"]
    for name in os.listdir(tmp_path / "cut"):  # saved under max_iter 14: shorter histories
        os.rename(tmp_path / "cut" / name, tmp_path / name)
    os.rename(tmp_path / "step_000014.npz", tmp_path / "cut" / "step_000014.npz")
    resumed = _ckpt_solve(cfg, d, tmp_path / "cut", 7, False, None)
    _assert_same_result(resumed, whole)
    os.remove(tmp_path / "cut" / "step_000014.npz")
    for name in ("step_000007.npz", "step_000014.npz"):
        os.remove(tmp_path / "whole" / name)
    _assert_same_checkpoints(tmp_path / "cut", tmp_path / "whole")


def test_checkpointed_device_form_matches_jax(tmp_path):
    """float64, stopping early inside a segment."""
    cfg = dataclasses.replace(VIDEO_TRITD, rank=RANK, max_iter=40, dtype="float64", tol=1e-2)
    d = _data(2)
    with jax.enable_x64(True):
        init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, RANK, np.float64)]
        jres = j_checkpointed(jnp.asarray(d), JConfig(**dataclasses.asdict(cfg)), str(tmp_path / "jax"), every=4,
                              key=jax.random.PRNGKey(0))
        want = {f: np.asarray(getattr(jres, f)) for f in jres._fields}
    got = _ckpt_solve(cfg, d, tmp_path / "port", 4, False, init)
    n = int(want["n_iters"])
    assert got.n_iters == n and 10 < n < cfg.max_iter and n % 4  # inside a segment
    np.testing.assert_allclose(got.err_hist.numpy()[:n], want["err_hist"][:n], rtol=1e-8)
    assert np.isnan(got.err_hist.numpy()[n:]).all()
    for f in ("a", "b", "c", "o"):
        w = want[f]
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-6, atol=1e-8 * np.abs(w).max(), err_msg=f)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


# --- the outlier solver -------------------------------------------------------

OUTLIER_CASES = {"defaults": dict(), "early_stop": dict(tol=3e-3), "tol0": dict(max_iter=30, tol=0.0)}


def _outlier_cfg(case, dtype="float32"):
    return OutlierConfig(**{"rank": RANK, "dtype": dtype, **OUTLIER_CASES[case]})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(OUTLIER_CASES))
def test_outlier_device_form_is_the_eager_loop_bitwise(case, dtype):
    cfg = _outlier_cfg(case, dtype)
    x, init = _tensor(_data(3), cfg), _init(cfg.np_dtype().type, seed=3)
    eager = outlier._outlier_run(x, cfg, init, None, graphs=None)
    device = outlier._outlier_run(x, cfg, init, None, graphs=False)
    _assert_same_result(device, eager)
    if case == "tol0":
        assert eager.n_iters == cfg.max_iter
    elif case == "early_stop":
        assert 2 < eager.n_iters < cfg.max_iter


@pytest.mark.parametrize("case", ["defaults", "early_stop"])
def test_outlier_device_form_matches_jax(case):
    cfg = _outlier_cfg(case, "float64")
    x = _data(4)
    with jax.enable_x64(True):
        init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, RANK, np.float64)]
        jres = j_outlier(jnp.asarray(x), JOutlierConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0))
        want = {f: np.asarray(getattr(jres, f)) for f in jres._fields}
    got = outlier._outlier_run(_tensor(x, cfg), cfg, init, None, graphs=False)
    _assert_matches_jax(got, want, ("a", "b", "c", "o"))


def _assert_matches_jax(got, want, fields):
    n = int(want["n_iters"])
    assert got.n_iters == n > 2
    hist = got.err_hist.numpy()
    assert hist.dtype == np.float64 and hist.shape == want["err_hist"].shape
    np.testing.assert_allclose(hist[:n], want["err_hist"][:n], rtol=1e-8)
    assert np.isnan(hist[n:]).all() and np.isnan(want["err_hist"][n:]).all()
    for f in fields:
        w = want[f]
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-6, atol=1e-8 * np.abs(w).max(), err_msg=f)


# --- ALS and MALS -------------------------------------------------------------

ALS_CASES = {"als_early_stop": (False, dict(tol=1e-4)), "als_tol0": (False, dict(tol=0.0)),
             "mals": (True, dict(tol=1e-4))}


def _als_cfg(case, dtype="float32"):
    mals, fields = ALS_CASES[case]
    return mals, TriTDConfig(**{"rank": RANK, "max_iter": 40, "dtype": dtype, **fields})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(ALS_CASES))
def test_als_device_form_is_the_eager_loop_bitwise(case, dtype):
    """ALS stops early inside the loop (the iteration that sets the flag
    still sweeps); MALS runs max_iter iterations whatever its tol."""
    mals, cfg = _als_cfg(case, dtype)
    x, init = _tensor(_data(5, spikes=0.0), cfg), _init(cfg.np_dtype().type, seed=5)
    eager = als._als_run(x, cfg, mals, init, None, graphs=None)
    device = als._als_run(x, cfg, mals, init, None, graphs=False)
    _assert_same_result(device, eager)
    if case == "als_early_stop":
        assert 2 < eager.n_iters < cfg.max_iter
    else:
        assert eager.n_iters == cfg.max_iter


@pytest.mark.parametrize("case", ["als_early_stop", "mals"])
def test_als_device_form_matches_jax(case):
    mals, cfg = _als_cfg(case, "float64")
    x = _data(6, spikes=0.0)
    with jax.enable_x64(True):
        init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, RANK, np.float64)]
        jres = (j_mals if mals else j_als)(jnp.asarray(x), JConfig(**dataclasses.asdict(cfg)),
                                            key=jax.random.PRNGKey(0))
        want = {f: np.asarray(getattr(jres, f)) for f in jres._fields}
    got = als._als_run(_tensor(x, cfg), cfg, mals, init, None, graphs=False)
    _assert_matches_jax(got, want, ("a", "b", "c"))
    assert (got.n_iters == cfg.max_iter) == mals


# --- the routes and the graph route's control flow ---------------------------


def test_public_entry_points_on_the_cpu_take_the_eager_loop(tmp_path, monkeypatch):
    """On the CPU no public entry point reaches the device form's stepper."""
    made = []

    class Recorded(admm._Stepper):
        def __init__(self, *args, **kwargs):
            made.append(args)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(admm, "_Stepper", Recorded)
    x = torch.from_numpy(_data(7))
    cfg = TriTDConfig(rank=RANK, max_iter=4)
    tritd_admm_checkpointed(x, cfg, str(tmp_path), every=2)
    tritd_admm_outlier(x, OutlierConfig(rank=RANK, max_iter=4))
    tritd_als(x, cfg)
    tritd_mals(x, cfg)
    tritd_admm(x, cfg)
    assert made == []
    # the device form does reach it
    als._als_run(x.float(), cfg, True, None, None, graphs=False)
    assert len(made) == 1


def test_pinv_and_lstsq_take_the_eager_loop_on_the_card():
    """Their torch forms read back to the host inside the solve, which a
    CUDA graph cannot capture: the route is chosen before any capture."""
    cuda = torch.device("cuda")
    assert admm._graph_route(cuda, method="cholesky")
    for method in ("pinv", "lstsq"):
        assert method in admm.UNCAPTURED_METHODS
        assert not admm._graph_route(cuda, method=method)
    assert not admm._graph_route(torch.device("cpu"), method="cholesky")
    assert not admm._graph_route(cuda, eager=True, method="cholesky")


class _FakeGraph:
    """Stands in for `hopper_kernels.CountedGraph` on the CPU: the capture
    records the block, each replay runs it."""

    captures: list = []

    def __init__(self, fn, pool, tallies=()):
        self.fn = fn
        _FakeGraph.captures.append(fn)

    def replay(self):
        self.fn()


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """The graph route on the CPU: streams that do nothing, graphs that
    replay the captured block's Python. Returns the list of captures."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(hopper_kernels, "CountedGraph", _FakeGraph)
    _FakeGraph.captures = []
    return _FakeGraph.captures


@pytest.mark.parametrize("every", [1, 3])
def test_checkpointed_loop_captures_two_graphs_for_the_whole_call(tmp_path, fake_graphs, monkeypatch, every):
    """One loop for the call: the first block eager, a capture at the
    second and third (one a parity), none in a later segment; the result and
    the checkpoints the eager loop's."""
    cfg = _ckpt_cfg("f32", 0.0)
    d, init = _data(8), _init(np.float32, seed=8)
    saves = []
    real_save = checkpointed.save_state

    def save(path, state):
        saves.append(len(fake_graphs))
        return real_save(path, state)

    monkeypatch.setattr(checkpointed, "save_state", save)
    graphs = _ckpt_solve(cfg, d, tmp_path / "graphs", every, True, init)
    # the captures are made at the second and third iterations, whatever
    # the segment: every=1 saves after each iteration, every=3 after three
    assert len(fake_graphs) == 2 and len(saves) == -(-cfg.max_iter // every)
    assert saves[:3] == ([0, 1, 2] if every == 1 else [2, 2, 2]) and set(saves[2:]) == {2}
    monkeypatch.setattr(checkpointed, "save_state", real_save)
    eager = _ckpt_solve(cfg, d, tmp_path / "eager", every, None, init)
    _assert_same_result(graphs, eager)
    _assert_same_checkpoints(tmp_path / "graphs", tmp_path / "eager")


@pytest.mark.parametrize("solver", ["outlier", "als", "mals"])
def test_carried_loops_capture_one_graph_a_parity(fake_graphs, solver):
    """The outlier loop captures two graphs (O and the duals alternate
    between two sets of buffers), ALS and MALS one; the results are the
    eager loop's."""
    x = _data(9)
    if solver == "outlier":
        cfg = _outlier_cfg("tol0")
        init = _init(np.float32, seed=9)
        runs = [outlier._outlier_run(_tensor(x, cfg), cfg, init, None, graphs=g) for g in (True, None)]
    else:
        mals, cfg = _als_cfg("mals" if solver == "mals" else "als_tol0")
        init = _init(np.float32, seed=9)
        runs = [als._als_run(_tensor(x, cfg), cfg, mals, init, None, graphs=g) for g in (True, None)]
    assert len(fake_graphs) == (2 if solver == "outlier" else 1)
    _assert_same_result(*runs)
