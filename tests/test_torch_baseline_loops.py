"""PyTorch port: the SVT baselines' loops (`tt_trpca`, `rtrc`, `rc_fctn`,
`trpca_snn`, `baselines/device_loop.py`) and `tucker_hooi`'s
(`ops/toolbox_loop.py`) on their three routes, on the CPU.

The device form without graphs (forced) must give the host loop's bits: the
same operations, the host's scalars rounded to the run's dtype either way.
A stand-in CUDA graph (the capture records the iteration's Python, each
replay runs it) checks the graph route's control flow: one capture, two
with a warm route (refresh and reuse), bitwise the host loop. Against the
JAX package at float64, the tolerances of `tests/test_torch_baselines.py`:
err_hist rtol 1e-7 (both sides float64 LAPACK in other summation orders,
carried by an ADMM), final tensors atol 1e-7 of their norm; `tucker_hooi`'s
fit rtol 1e-10, its reconstruction atol 1e-10 of the tensor's norm (the
factors are unique up to sign). The randomized route of the video driver
takes the sketch JAX draws, injected through `svt.lowrank_sketch`.
"""

import contextlib
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu_torch.data.loaders import DatasetSpec, synthetic_traffic  # noqa: E402
from tritd_tpu_torch.data.synthetic import uniform_missing_mask  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels, toolbox_loop  # noqa: E402

jttnn, ttnn = (importlib.import_module(f"{p}.baselines.ttnn") for p in ("tritd_tpu", "tritd_tpu_torch"))
jrtrc, rtrc = (importlib.import_module(f"{p}.baselines.rtrc") for p in ("tritd_tpu", "tritd_tpu_torch"))
jfctn, fctn = (importlib.import_module(f"{p}.baselines.rc_fctn") for p in ("tritd_tpu", "tritd_tpu_torch"))
jdecomp, decomp = (importlib.import_module(f"{p}.ops.decomp") for p in ("tritd_tpu", "tritd_tpu_torch"))
jtrpca, trpca = (importlib.import_module(f"{p}.baselines.trpca") for p in ("tritd_tpu", "tritd_tpu_torch"))
jsvt, tsvt = (importlib.import_module(f"{p}.ops.svt") for p in ("tritd_tpu", "tritd_tpu_torch"))
device_loop = importlib.import_module("tritd_tpu_torch.baselines.device_loop")
device_linalg = importlib.import_module("tritd_tpu_torch.ops.device_linalg")
penalty = importlib.import_module("tritd_tpu_torch.baselines.penalty")

RTOL = 1e-7
SUBDIM = 4
SHAPE = (12, 10, 16)
ITERS = 12
CHUNK = 5
CASES = ("tt_trpca", "rtrc", "fctn_traffic_warm", "fctn_video_lowrank", "tucker_hooi", "trpca_snn")
# trpca_snn's arguments: test_torch_baselines.py's parity case
SNN_ARGS = {"alpha": (1.0, 0.8, 1.2), "mu": 1e-3}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _warm_threshold(monkeypatch):
    """The warm threshold lowered on both sides, so that this small
    problem's unfoldings carry a basis."""
    monkeypatch.setattr(jsvt, "WARM_MIN_DIM", 8)
    monkeypatch.setattr(tsvt, "WARM_MIN_DIM", 8)


def _problem(seed=7):
    spec = DatasetSpec("tiny", "traffic", "T", SHAPE, fctn_subdim=SUBDIM, sofia_period=4)
    x = synthetic_traffic(spec, np.random.default_rng(seed)).astype(np.float64)
    mask = uniform_missing_mask(np.random.default_rng(seed + 1), SHAPE, 0.10)
    return x, mask, np.where(mask, x, 0.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_sketch(p, q, b, dtype, device):
    """The sketch the JAX package draws for a p x q matrix (p <= q)."""
    with jax.enable_x64(True):
        key = jax.random.fold_in(jax.random.PRNGKey(tsvt.LOWRANK_SEED), p * 131071 + q)
        omega = np.array(jax.random.normal(key, (q, b), jnp.float64))
    return torch.from_numpy(omega).to(dtype=dtype, device=device)


def _traffic4(x, y):
    """The traffic driver's 4-way reshape and lambda, for a call of
    `rc_fctn` in chunks of CHUNK (the driver's own chunk is 25)."""
    i, j, k = SHAPE
    n3 = k // SUBDIM
    lam = 5000.0 / math.sqrt(max(i, j) * n3 * SUBDIM)
    return fctn._split_mode3(_t(y), n3, SUBDIM), fctn._split_mode3(_t(x), n3, SUBDIM), lam


def _torch_call(name):
    """The case's call on float64 CPU tensors: a dict of its outputs."""
    x, mask, y = _problem()
    if name == "tt_trpca":
        z, s, hist, n = ttnn.tt_trpca(_t(y), origin=_t(x), max_iter=ITERS, svt_method="warm:3")
        return {"z": z, "s": s, "hist": hist}
    if name == "rtrc":
        xh, yh, hist, _n = rtrc.rtrc(_t(y), _t(mask), origin=_t(x), max_iter=ITERS, svt_method="gram")
        return {"x": xh, "y": yh, "hist": hist}
    if name == "fctn_traffic_warm":
        y4, x4, lam = _traffic4(x, y)
        xh, s, hist = fctn.rc_fctn(y4, lam, torch.ones_like(y4), origin=x4, f=0.1, max_iter=ITERS,
                                   svt_method="warm:3", chunk=CHUNK)
        return {"x": xh, "s": s, "hist": hist}
    if name == "fctn_video_lowrank":
        xh, s, hist = fctn.rc_fctn_driver_video(_t(y), _t(mask), SUBDIM, origin=_t(x), max_iter=ITERS,
                                                svt_method="lowrank:6")
        return {"x": xh, "s": s, "hist": hist}
    if name == "trpca_snn":
        low, e, hist = trpca.trpca_snn(_t(y), max_iter=ITERS, **SNN_ARGS)
        return {"l": low, "e": e, "hist": hist}
    out = decomp.tucker_hooi(_t(x), (3, 4, 5), max_iters=20, tol=1e-9)
    return {"core": out["core"], **{f"u{m}": u for m, u in enumerate(out["factors"])}, "fit": out["fit"],
            "n_iters": torch.tensor(out["n_iters"])}


def _jax_call(name):
    x, mask, y = _problem()
    with jax.enable_x64(True):
        if name == "tt_trpca":
            z, s, hist, _n = jttnn.tt_trpca(jnp.asarray(y), origin=jnp.asarray(x), max_iter=ITERS,
                                            svt_method="warm:3")
            return {"z": z, "s": s, "hist": hist}
        if name == "rtrc":
            xh, yh, hist, _n = jrtrc.rtrc(jnp.asarray(y), jnp.asarray(mask), origin=jnp.asarray(x), max_iter=ITERS,
                                          svt_method="gram")
            return {"x": xh, "y": yh, "hist": hist}
        if name == "fctn_traffic_warm":
            y4, x4, lam = _traffic4(x, y)
            xh, s, hist = jfctn.rc_fctn(jnp.asarray(y4.numpy()), lam, jnp.ones(y4.shape), origin=jnp.asarray(x4.numpy()),
                                        f=0.1, max_iter=ITERS, svt_method="warm:3", chunk=CHUNK)
            return {"x": fctn._merge_mode3(_t(np.array(xh))), "s": fctn._merge_mode3(_t(np.array(s))),
                    "hist": hist}
        if name == "fctn_video_lowrank":
            xh, s, hist = jfctn.rc_fctn_driver_video(jnp.asarray(y), jnp.asarray(mask), SUBDIM, origin=jnp.asarray(x),
                                                     max_iter=ITERS, svt_method="lowrank:6")
            return {"x": xh, "s": s, "hist": hist}
        if name == "trpca_snn":
            low, e, hist = jtrpca.trpca_snn(jnp.asarray(y), max_iter=ITERS, **SNN_ARGS)
            return {"l": low, "e": e, "hist": hist}
        out = jdecomp.tucker_hooi(jnp.asarray(x), (3, 4, 5), max_iters=20, tol=1e-9)
        return {"core": out["core"], **{f"u{m}": u for m, u in enumerate(out["factors"])}, "fit": out["fit"],
                "n_iters": out["n_iters"]}


def _call(name, route, monkeypatch):
    monkeypatch.setattr(tsvt, "lowrank_sketch", _jax_sketch)
    with toolbox_loop.forced_route(route):
        out = _torch_call(name)
    if name == "fctn_traffic_warm":
        out = {k: fctn._merge_mode3(v) if v.dim() == 4 else v for k, v in out.items()}
    return out


def _same_bits(a: dict, b: dict) -> list:
    """The keys whose tensors differ in a bit (NaN where NaN)."""
    return [k for k in a if not (torch.equal(a[k].isnan(), b[k].isnan())
                                 and torch.equal(a[k].nan_to_num(), b[k].nan_to_num()))]


@pytest.mark.parametrize("name", CASES)
def test_device_form_without_graphs_is_the_host_loop_bitwise(name, monkeypatch):
    host = _call(name, None, monkeypatch)
    device = _call(name, False, monkeypatch)
    assert _same_bits(device, host) == []
    assert all(v.dtype in (torch.float64, torch.int64) for v in host.values())


def _reconstruction(core, factors):
    return np.einsum("abc,ia,jb,kc->ijk", np.asarray(core), *[np.asarray(u) for u in factors])


@pytest.mark.parametrize("name", CASES)
def test_both_routes_match_jax(name, monkeypatch):
    want = _jax_call(name)
    for route in (None, False):
        got = _call(name, route, monkeypatch)
        if name == "tucker_hooi":
            assert int(got["n_iters"]) == int(want["n_iters"]) >= 2
            np.testing.assert_allclose(float(got["fit"]), float(want["fit"]), rtol=1e-10)
            g = _reconstruction(got["core"], [got[f"u{m}"] for m in range(3)])
            w = _reconstruction(want["core"], [want[f"u{m}"] for m in range(3)])
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10 * np.linalg.norm(_problem()[0]))
            continue
        hist, jhist = got["hist"].numpy(), np.asarray(want["hist"])
        assert hist.shape == (ITERS,) and np.isfinite(jhist).all() and jhist[-1] < jhist[0]
        np.testing.assert_allclose(hist, jhist, rtol=RTOL)
        for key in got:
            if key != "hist":
                w = np.asarray(want[key])
                np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=RTOL * max(np.linalg.norm(w), 1.0))


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


@pytest.mark.parametrize("name", CASES)
def test_graph_route_with_a_stand_in_graph(name, monkeypatch):
    """One capture a call, two where a warm route refreshes and reuses; the
    result bitwise the host loop's."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(hopper_kernels, "CountedGraph", _FakeGraph)
    _FakeGraph.captures = []
    graph = _call(name, True, monkeypatch)
    assert len(_FakeGraph.captures) == (2 if name in ("tt_trpca", "fctn_traffic_warm") else 1)
    assert _same_bits(graph, _call(name, None, monkeypatch)) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["tt_trpca", "rtrc", "fctn"])
def test_penalty_tables_are_grown_penalty_bitwise(name, dtype, monkeypatch):
    """Each loop's table holds its penalties as `grown_penalty` computes
    them on the host (rtrc's capped at 1e6: mu0 = 1e5 reaches the cap at
    iteration 25), in the run's dtype."""
    made = []

    class Recorded(device_loop.Scalars):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    x, mask, y = _problem()
    n = 30
    module = {"tt_trpca": ttnn, "rtrc": rtrc, "fctn": fctn}[name]
    monkeypatch.setattr(module, "Scalars", Recorded)
    with toolbox_loop.forced_route(False):
        if name == "tt_trpca":
            ttnn.tt_trpca(_t(y).to(dtype), max_iter=n, svt_method="gram")
            want = {"gam": (1e-3, 1.1, None), "det": (2e-3, 1.1, None)}
        elif name == "rtrc":
            rtrc.rtrc(_t(y).to(dtype), _t(mask), mu=1e5, max_iter=n, svt_method="gram")
            want = {"mu": (1e5, 1.1, 1e6)}
        else:
            fctn.rc_fctn_driver_traffic(_t(y).to(dtype), _t(mask), SUBDIM, max_iter=n, svt_method="gram")
            want = {"gamma": (1e-3, 1.5, None), "deta": (1e-3, 1.5, None)}
    (table,) = made
    assert table.table.dtype == dtype and table.table.shape[0] == n
    for key, (base, rate, cap) in want.items():
        values = [penalty.grown_penalty(base, rate, k, dtype, cap=cap) for k in range(n)]
        assert [row[key] for row in table.rows] == values
        column = table.table[:, table.names.index(key)].to(torch.float64)
        assert torch.equal(column, torch.tensor(values, dtype=torch.float64))
        if cap is not None:
            assert values[-1] == cap and values[0] < cap
        counter = torch.tensor(n - 1)
        assert torch.equal(table.at(counter)[key], table.table[n - 1, table.names.index(key)])


@pytest.mark.parametrize("max_iter, chunk, period", [(12, 5, 3), (100, 25, 8), (7, 7, 4), (9, 4, 1), (3, 25, 8)])
def test_refresh_schedule_is_run_warm_blocks(max_iter, chunk, period):
    """The device forms' schedule, chunk by chunk, is the refreshes that
    `run_warm_blocks` gives each chunk's block."""
    seen = []
    for k0 in range(0, max_iter, chunk):
        tsvt.run_warm_blocks(lambda k, c, refresh: seen.append((k, refresh)), None, k0, min(chunk, max_iter - k0),
                             period)
    assert [k for k, _ in seen] == list(range(max_iter))
    assert device_loop.schedule(max_iter, chunk, period) == [r for _, r in seen]
    assert device_loop.schedule(max_iter, chunk, None) == [None] * max_iter


def test_histories_are_nan_past_the_iterations_run():
    """A device-form loop advanced to the end of its first chunk has
    written its history there and no further: the rest stays NaN, and what
    it wrote is the whole run's start bitwise."""
    x, _mask, y = _problem()
    y4, x4, lam = _traffic4(x, y)
    runs = []
    for segments in ([CHUNK], range(CHUNK, ITERS + CHUNK, CHUNK)):
        hist = torch.full((ITERS,), float("nan"), dtype=torch.float64)
        step = fctn._rc_fctn_step(y4, torch.ones_like(y4), x4, hist, lam, 0.1, 1e-3, 1e-3, ITERS, "gram")
        zeros = torch.zeros_like(y4)
        carry = {"x": zeros, "y": y4, "e": zeros, "s": zeros, "p": zeros, "q": zeros,
                 **{f"z{i}": zeros for i in range(3)}}
        device_loop.run(step, carry, [None] * ITERS, segments, False)
        runs.append(hist)
    part, whole = runs
    assert torch.isfinite(part[:CHUNK]).all() and torch.isnan(part[CHUNK:]).all()
    assert torch.isfinite(whole).all() and torch.equal(part[:CHUNK], whole[:CHUNK])


def test_an_uncaptured_svt_route_takes_the_host_loop(monkeypatch):
    """The "svd" route takes the graph route where every unfolding's thin
    side is at most `device_linalg.SVD_JACOBI_MAX_K` (the Jacobi SVD, which
    a graph captures: the taxi cuts), and the host loop where graphs would
    run past it (gesvdj reads back to the host: the video cut, thin side
    4800), chosen before any capture; a forced route wins."""
    cuda, taxi = torch.device("cuda", 0), [(100, 50000), (10000, 500)]
    video = [(76800, 300), (4800, 4800), (3600, 6400)]
    assert not hasattr(tsvt, "UNCAPTURED_METHODS")
    assert device_loop.route(cuda, "svd", taxi) is True and device_loop.route(cuda, "gram", taxi) is True
    assert device_loop.route(cuda, "svd", video) is None and device_loop.route(cuda, "auto:512", video) is True
    assert device_loop.route(cuda, "warm:8", taxi) is True
    assert device_loop.route(torch.device("cpu"), "gram", taxi) is None
    with toolbox_loop.forced_route(False):
        assert device_loop.route(cuda, "svd", video) is False
    monkeypatch.setattr(device_linalg, "SVD_JACOBI_MAX_K", 499)
    assert device_loop.route(cuda, "svd", taxi) is None
    monkeypatch.setattr(device_linalg, "SVD_JACOBI_MAX_K", 4800)
    assert device_loop.route(cuda, "svd", video) is True


# (route, unfoldings, whether a graph captures it): the baselines' cuts at
# taxi and on the highway video, and the edges of the captured eigh (n <= 512)
CAPTURE_CASES = [
    ("gram", [(100, 50000), (10000, 500)], True),                         # ttnn at taxi
    ("gram", [(500, 10000), (50000, 100), (50000, 100)], True),           # ring at taxi
    ("gram", [(500, 10000), (5000, 1000), (5000, 1000)], False),          # fctn at taxi: 1000 x 1000 Grams
    ("warm:8", [(500, 10000), (5000, 1000), (5000, 1000)], False),
    ("warm:8", [(100, 50000), (10000, 500)], True),
    ("auto:512", [(76800, 300), (4800, 4800), (3600, 6400)], True),       # fctn video: gram, lowrank:512 twice
    ("auto", [(76800, 300), (4800, 4800)], False),                        # lowrank:1024: a 1024 x 1024 eigh
    ("lowrank:64", [(3000, 4000)], True),
    ("gram", [(512, 9000)], True),
    ("gram", [(9000, 513)], False),
    ("svd", [(10, 20)], True),                                            # the Jacobi SVD
    ("svd", [(100, 50000), (10000, 500)], True),                          # ttnn at taxi
    ("svd", [(500, 10000), (5000, 1000), (5000, 1000)], True),            # fctn at taxi
    ("svd", [(1024, 9000)], True),                                        # the Jacobi SVD's limit
    ("svd", [(9000, 1025)], False),                                       # gesvdj past it
    ("svd", [(76800, 300), (4800, 4800), (3600, 6400)], False),           # the video cut
]


@pytest.mark.parametrize("method, shapes, want", CAPTURE_CASES, ids=lambda v: str(v).replace(" ", ""))
def test_a_loop_whose_eigh_no_graph_captures_takes_the_host_loop(method, shapes, want):
    """`svt.captures`: a graph holds the route only where every eigh it
    runs is of n <= 512 (cuSOLVER's batched syev; Xsyevd past it reads back
    to the host), so fctn's taxi loop, whose 1000 x 1000 Grams go to
    Xsyevd, takes the host loop on the card, chosen before any capture; the
    svd route where every SVD's thin side is at most SVD_JACOBI_MAX_K; a
    forced device form without graphs stays that."""
    cuda = torch.device("cuda", 0)
    assert tsvt.captures(method, shapes) is want
    assert device_loop.route(cuda, method, shapes) is (True if want else None)
    with toolbox_loop.forced_route(False):
        assert device_loop.route(cuda, method, shapes) is False


def test_tucker_hooi_with_a_mode_past_512_takes_the_host_loop(monkeypatch):
    """On the card tucker_hooi's loop takes the graph route only where every
    mode's eigh can be captured; the cut is asked of the device_linalg
    limit, here lowered so that a small tensor crosses it."""
    seen = []
    real = toolbox_loop.run

    def run(*args, **kwargs):
        seen.append(args[4] if len(args) > 4 else kwargs.get("captures", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(toolbox_loop, "run", run)
    x = torch.from_numpy(np.random.default_rng(3).random((6, 7, 9)))
    decomp.tucker_hooi(x, (2, 2, 2), max_iters=2, tol=0.0)
    monkeypatch.setattr(decomp.device_linalg, "XSYEV_BATCHED_MAX_N", 8)
    decomp.tucker_hooi(x, (2, 2, 2), max_iters=2, tol=0.0)
    assert seen == [True, False]
    assert toolbox_loop.route(torch.device("cuda", 0), False) is None
    assert toolbox_loop.route(torch.device("cuda", 0), True) is True