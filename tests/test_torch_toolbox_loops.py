"""PyTorch port, the Tensor Toolbox's solver loops in their device form
(`tritd_tpu_torch/ops/toolbox_loop.py`): `cp_als`, `cp_als_sparse`,
`cp_nmu`, `cp_apr`, `cp_arls`, `eig_sshopm`, `eig_sshopmc`, `eig_geap`,
`gcp_opt` and `cp_sym`, the reference's `lax.while_loop`s.

On a CUDA tensor each runs as CUDA graph replays, one an iteration; here,
on the CPU, the same iterations run without graphs
(`toolbox_loop.forced_route(False)`) and are held bitwise to the host loop
(the CPU's route) over whole calls, `n_iters` included: at a tol that stops
each early and at tol 0, at the stop's edges (a NaN change stops, the
change is +inf at the entry, a NaN tol runs nothing), with `cp_arls`'s
sample indices drawn before the loop and `cp_apr`'s inner sweeps unrolled
in its iteration. The graph route's control flow runs too, with a stand-in
for the CUDA graph that replays the captured iteration's Python: one
capture a call. Inputs are float64, from `tests/torch_toolbox_loop_cases.py`.
The parity of each function with the JAX package stays in
`test_torch_kruskal_decomp.py`, `test_torch_toolbox.py` and
`test_torch_toolbox_tail.py`; the card's captures, synchronizing calls and
the graph route against the route without graphs are in
`test_torch_cuda.py`."""

import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_toolbox_loop_cases as cases  # noqa: E402
from tritd_tpu_torch import ops  # noqa: E402
from tritd_tpu_torch.ops import cp_variants, hopper_kernels, toolbox_loop  # noqa: E402
from tritd_tpu_torch.solvers import admm  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _routes(name, tol, **kw) -> dict:
    """The call on the host loop (None) and on the device form without
    graphs (False)."""
    out = {}
    for graphs in (None, False):
        with toolbox_loop.forced_route(graphs):
            out[graphs] = cases.call(name, tol, **kw)
    return out


@pytest.mark.parametrize("stop", ["early", "tol0"])
@pytest.mark.parametrize("name", cases.NAMES)
def test_device_form_is_the_host_loop_bitwise(name, stop):
    tol = cases.EARLY_TOL[name] if stop == "early" else 0.0
    got = _routes(name, tol)
    assert cases.same_bits(got[False], got[None]) == []
    n, cap = got[None]["n_iters"], cases.MAX_ITERS[name]
    assert type(n) is int and (2 <= n < cap if stop == "early" else n == cap)


def test_the_cpu_takes_the_host_loop_and_cuda_the_graph_route(monkeypatch):
    """The route: the host loop on the CPU (no device-form loop made), the
    graph route on a CUDA device; `forced_route` overrides both, innermost
    first."""
    assert toolbox_loop.route(torch.device("cpu")) is None
    assert toolbox_loop.route(torch.device("cuda")) is True
    with toolbox_loop.forced_route(False):
        assert toolbox_loop.route(torch.device("cuda")) is False
        with toolbox_loop.forced_route(None):
            assert toolbox_loop.route(torch.device("cuda")) is None
        assert toolbox_loop.route(torch.device("cpu")) is False
    made = []
    real = admm._DeviceLoop
    monkeypatch.setattr(admm, "_DeviceLoop", lambda *a, **kw: made.append(1) or real(*a, **kw))
    assert cases.call("cp_als", 0.0)["n_iters"] == cases.MAX_ITERS["cp_als"] and made == []
    with toolbox_loop.forced_route(False):
        cases.call("cp_als", 0.0)
    assert made == [1]


class _FakeGraph:
    """Stands in for `hopper_kernels.CountedGraph` on the CPU: the capture
    records the iteration, each replay runs it."""

    captures: list = []

    def __init__(self, fn, pool, tallies=()):
        self.fn = fn
        _FakeGraph.captures.append(fn)

    def replay(self):
        self.fn()


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("name", cases.NAMES)
def test_graph_route_with_a_stand_in_graph_captures_once(monkeypatch, name):
    """The graph route's control flow on the CPU: the first iteration eager,
    one capture at the second, a replay an iteration after it; the result
    bitwise the host loop's, at a tol that stops early."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(hopper_kernels, "CountedGraph", _FakeGraph)
    _FakeGraph.captures = []
    with toolbox_loop.forced_route(True):
        graph = cases.call(name, cases.EARLY_TOL[name])
    assert len(_FakeGraph.captures) == 1
    with toolbox_loop.forced_route(None):
        host = cases.call(name, cases.EARLY_TOL[name])
    assert cases.same_bits(graph, host) == []


def _with_nan(name: str) -> dict:
    """The inputs with a NaN in the start of `name`'s iterate."""
    data = cases.inputs()
    if name in ("eig_sshopm", "eig_geap"):
        data["x0"] = data["x0"].copy()
        data["x0"][0] = np.nan
    elif name == "cp_sym":
        data["sym_init"] = (data["sym_init"][0], np.full_like(data["sym_init"][1], np.nan))
    else:
        data["init"] = [u.copy() for u in data["init"]]
        data["init"][-1][0, 0] = np.nan
    return data


# iterations at tol = +inf: the change at the entry is +inf, which passes; a
# fit-change or Adam loop's first change is again +inf (from -inf or +inf),
# so it runs a second iteration; an eigenvalue's or cp_apr's KKT's is finite
INF_TOL_ITERS = {"cp_als": 2, "cp_apr": 1, "eig_sshopm": 1, "eig_geap": 1, "gcp_opt": 2, "cp_sym": 2,
                 "cp_nmu": 2}


@pytest.mark.parametrize("edge", ["nan_change", "inf_tol", "nan_tol", "no_iterations"])
@pytest.mark.parametrize("name", sorted(INF_TOL_ITERS))
def test_stop_edges_on_both_routes(name, edge):
    """A NaN change stops the loop after the iteration that made it (NaN >=
    tol is false, as in the reference's `cond`), also at tol 0; tol = +inf
    runs while the change is +inf; a NaN tol or max_iters = 0 runs
    nothing."""
    kw = {"nan_change": dict(tol=0.0, data=_with_nan(name)), "inf_tol": dict(tol=math.inf),
          "nan_tol": dict(tol=math.nan), "no_iterations": dict(tol=0.0, max_iters=0)}[edge]
    got = _routes(name, **kw)
    assert cases.same_bits(got[False], got[None]) == []
    want = {"nan_change": 1, "inf_tol": INF_TOL_ITERS[name], "nan_tol": 0, "no_iterations": 0}[edge]
    assert got[None]["n_iters"] == want


def test_cp_als_with_no_iterations_returns_the_init_and_minus_inf():
    data = cases.inputs()
    res = cases.call("cp_als", 0.0, max_iters=0)
    assert float(res["fit"]) == -math.inf
    full = ops.ktensor_full(res["factors"], res["weights"])
    np.testing.assert_allclose(full.numpy(), np.einsum("ir,jr,kr->ijk", *data["init"]), rtol=1e-12)


def test_cp_arls_iteration_k_reads_the_kth_draws():
    """Stopped early at n of max_iters iterations, cp_arls is bitwise the
    call of n iterations: iteration k reads the k-th draws whatever
    max_iters is; and the draws are the ones the iterations once drew in
    the loop, in the same order (the first two iterations by hand)."""
    early = cases.call("cp_arls", cases.EARLY_TOL["cp_arls"])
    n = early["n_iters"]
    assert 2 <= n < cases.MAX_ITERS["cp_arls"]
    assert cases.same_bits(cases.call("cp_arls", 0.0, max_iters=n), early) == []
    data = cases.inputs()
    x = torch.from_numpy(data["x"])
    gen = torch.Generator().manual_seed(1)
    factors = [torch.from_numpy(u) for u in data["init"]]
    for _it in range(2):
        for mode in range(3):
            idx = [torch.randint(0, x.shape[ax], (30,), generator=gen) for ax in range(3) if ax != mode]
            factors[mode] = cp_variants.arls_mode_solve(x, factors, mode, idx)
    want, weights = ops.cp_normalize(factors)
    got = cases.call("cp_arls", 0.0, max_iters=2)
    for g, w in zip([*got["factors"], got["weights"]], [*want, weights]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("graphs", [None, False], ids=["host_loop", "device_form"])
def test_cp_arls_draws_every_iterations_indices_before_the_loop(graphs):
    """The generator after the call has drawn max_iters x N x (N - 1) index
    sets on every route, however early the loop stops."""
    x = torch.from_numpy(cases.inputs()["x"])
    gen = torch.Generator().manual_seed(4)
    with toolbox_loop.forced_route(graphs):
        res = ops.cp_arls(x, 2, n_samples=30, max_iters=9, tol=1.0, generator=gen)
    assert res["n_iters"] < 9
    want = torch.Generator().manual_seed(4)
    ops.cp_arls(x, 2, n_samples=30, max_iters=0, generator=want)  # the uniform init's draws
    for _ in range(9 * 3 * 2):
        torch.randint(0, 7, (30,), generator=want)
    assert torch.equal(gen.get_state(), want.get_state())


@pytest.mark.parametrize("max_inner", [1, 4])
def test_cp_apr_inner_sweeps_unrolled_in_the_iteration(max_inner):
    """cp_apr's `max_inner` sweeps run inside each outer iteration on both
    routes: bitwise, and another count gives another answer."""
    counts = torch.from_numpy(cases.inputs()["counts"])
    init = [torch.from_numpy(u) for u in cases.inputs()["init"]]
    out = {}
    for graphs in (None, False):
        with toolbox_loop.forced_route(graphs):
            out[graphs] = ops.cp_apr(counts, 2, max_outer=5, max_inner=max_inner, tol=0.0, init_factors=init)
    assert cases.same_bits(out[False], out[None]) == [] and out[None]["n_iters"] == 5
    other = ops.cp_apr(counts, 2, max_outer=5, max_inner=max_inner + 1, tol=0.0, init_factors=init)
    assert not torch.equal(other["factors"][0], out[None]["factors"][0])


def test_adam_descent_updates_the_parameters_in_place_under_no_grad():
    """The objective reads the caller's leaves, which hold the last step's
    point after the call; the descent runs under `torch.no_grad()` too."""
    target = torch.linspace(-1.0, 1.0, 7, dtype=torch.float64)
    p = torch.zeros(7, dtype=torch.float64, requires_grad=True)
    start = p.data_ptr()
    with torch.no_grad():
        value, steps = ops.symmetric.adam_descent(lambda: ((p - target) ** 2).sum(), [p], 0.1, 30, 0.0)
    assert steps == 30 and p.data_ptr() == start and p.requires_grad
    assert float(((p.detach() - target) ** 2).sum()) < float(value) < float((target**2).sum())
