"""PyTorch port, the sharded solve on the device form of the loop: the
penalties and the counter as 0-d tensors, each iteration one function of
device tensors whose sums go through the shard's `all_reduce`; as in the
reference's sharded `while_loop`, one iteration a step whatever `unroll`. On CUDA devices over NCCL each block after the first is one
replay of a CUDA graph that holds those calls; here, on the CPU over gloo,
the same blocks run eagerly (`_run_device_form(..., graphs=False,
shard=...)`), reached through `sharded_admm._local_solve` as
`tritd_admm_sharded` calls it (tests/torch_sharded_device_loop_worker.py),
and are held:

  * to the eager sharded loop bit for bit, in every field of the final state,
    the penalties and the collective's counts (4 calls an iteration, the same
    words), on a one-rank gloo group in this process and on 2 spawned gloo
    ranks: modes 1 and 3; float32, float64, masked and bf16 storage; origin
    given; unroll 1 and 3 (which the sharded loop does not read); tol 0 and
    an early stop. The same arithmetic on the same values, with the same
    sums;
  * to the JAX package's `tritd_admm_sharded` (on the virtual CPU devices)
    at tests/test_torch_parallel.py's tolerances: float64 rtol 1e-8 on the
    histories, float32 rtol 2e-3 (atol 1e-5), bf16 storage rtol 2e-2 (atol
    1e-4), O as there; sharding and gloo change the order of sums. The
    solves run 20 iterations: on this problem the JAX package's own one- and
    two-shard solves part by 5e-4 (float32) and 0.13 (bf16 storage) in
    err_hist by iteration 40, and by 1e-6 and 2e-4 up to iteration 20.

The route choice (`admm._graph_route`) and the collective's counts under a
capture (`hopper_kernels.CountedGraph` with `tallies`) are checked with the
backend and the graph stubbed; the graph route itself needs the card
(tests/test_torch_device_loop.py, one NCCL rank).
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from torch_sharded_device_loop_worker import ROUTES, STATE_FIELDS, arrays_of, routes  # noqa: E402
from tritd_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from tritd_tpu.parallel import tritd_admm_sharded as j_sharded  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.parallel import SlabCollective, make_mesh, sharded_admm  # noqa: E402
from tritd_tpu_torch.parallel.distributed import launch_local  # noqa: E402
from tritd_tpu_torch.solvers import admm  # noqa: E402
from tritd_tpu_torch.utils.config import COMPLETION_TRITD  # noqa: E402

SHAPE = (12, 10, 14)
RANK = 3
MAX_ITER = 20
SPAWN_TIMEOUT_S = 300.0
# relative change of err between iterations that the early-stop runs stop
# at, within 20 iterations in every case
EARLY_TOL = 2e-2

CASES = {
    "f32": dict(),
    "f64": dict(dtype="float64"),
    "masked": dict(masked=True),
    "bf16_storage": dict(storage_dtype="bfloat16"),
}
RUNS = {
    "unroll1": dict(unroll=1, tol=0.0),
    "unroll3": dict(unroll=3, tol=0.0),
    "unroll1_early_stop": dict(unroll=1, tol=EARLY_TOL),
    "unroll3_early_stop": dict(unroll=3, tol=EARLY_TOL),
}
# the runs of the two spawned ranks, a subset of the one-rank ones
SPAWNED_RUNS = ("unroll1", "unroll3_early_stop")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem():
    """Low-TriTD-rank truth + noise + sparse spikes, 10% missing: the truth,
    and the data zero-filled where missing, as float64 numpy."""
    rng = np.random.default_rng(0)
    n1, n2, n3 = SHAPE
    a = rng.standard_normal((n1, RANK, RANK))
    b = rng.standard_normal((RANK, n2, RANK))
    c = rng.standard_normal((RANK, RANK, n3))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = 10.0 * x / np.sqrt(np.mean(x**2)) + 0.1 * rng.standard_normal(SHAPE)
    x = x + (rng.random(SHAPE) < 0.02) * 20.0
    mask = rng.random(SHAPE) >= 0.1
    return x, np.where(mask, x, 0.0), mask


PROBLEM = _problem()


def _inputs(case: str, run: str):
    """(cfg, d, mask, origin, init) of a case and run, as numpy; the init is
    the reference's own draw (PRNGKey(0) at the unpadded shape), so that the
    JAX package's sharded solve starts where these do."""
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=MAX_ITER, **CASES[case], **RUNS[run])
    np_dt = cfg.np_dtype().type
    with jax.enable_x64(np_dt is np.float64):
        init = tuple(np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, RANK, np_dt))
    x, y, mask = PROBLEM
    return cfg, y.astype(np_dt), mask if cfg.masked else None, x.astype(np_dt), init


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _assert_same_routes(got: dict, key: str, run: str) -> None:
    """The two routes' entries of `arrays_of` for `key`: every field, the
    penalties, the counter and the audit bit for bit; an early-stop run
    stopped early, a tol-0 run ran max_iter iterations (one a step, whatever
    `unroll`)."""
    eager, device = ({k.split("/", 2)[2]: v for k, v in got.items() if k.startswith(f"{key}/{r}/")} for r in ROUTES)
    assert sorted(eager) == sorted(device)
    k = int(eager["k"])
    if RUNS[run]["tol"]:
        assert 2 < k < MAX_ITER and bool(eager["done"])
    else:
        assert k == MAX_ITER and eager["err_hist"].shape == (MAX_ITER,)
    audit = json.loads(str(eager["audit"]))
    assert audit["per_iter"]["calls"] == 4 and audit["n_iters"] == k and audit["setup"]["calls"] == 1
    assert str(eager["audit"]) == str(device["audit"])
    for name, want in eager.items():
        if name != "audit":
            assert want.dtype == device[name].dtype and want.shape == device[name].shape, name
            assert np.array_equal(_bits(device[name]), _bits(want)), name


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _one_rank(mesh, case, run, mode):
    cfg, d, mask, origin, init = _inputs(case, run)
    return routes(d, cfg, mesh.get_group("slab"), mode, mask, origin, init)


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", [1, 3], ids=["mode1", "mode3"])
def test_device_form_is_the_eager_sharded_loop_bitwise(mesh1, mode, case, run):
    key = f"{case}-{run}-mode{mode}"
    got = arrays_of(key, _one_rank(mesh1, case, run, mode))
    _assert_same_routes(got, key, run)


# ---------------------------------------------------------------------------
# two ranks, spawned
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of every spawned case, {rank: {entry: array}}."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    spec, arrays = {}, {}
    for mode in (1, 3):
        for case in CASES:
            for run in SPAWNED_RUNS:
                key = f"{case}-{run}-mode{mode}"
                cfg, d, mask, origin, init = _inputs(case, run)
                spec[key] = dict(cfg=dataclasses.asdict(cfg), mode=mode)
                arrays.update({f"{key}/d": d, f"{key}/origin": origin, f"{key}/a0": init[0], f"{key}/b0": init[1],
                               f"{key}/c0": init[2]})
                if mask is not None:
                    arrays[f"{key}/mask"] = mask
    np.savez(tmp / "cases.npz", spec=json.dumps(spec), **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(Path(__file__).parent), os.environ.get("PYTHONPATH")])))
    launch_local(2, ["--cases", str(tmp / "cases.npz"), "--out", str(tmp / "out")], timeout_s=SPAWN_TIMEOUT_S,
                 module="torch_sharded_device_loop_worker", env=env)
    out = {}
    for rank in range(2):
        with np.load(tmp / f"out.r{rank}.npz") as f:
            out[rank] = dict(f)
    return out


@pytest.mark.parametrize("run", SPAWNED_RUNS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", [1, 3], ids=["mode1", "mode3"])
def test_device_form_is_the_eager_sharded_loop_bitwise_on_two_ranks(two_ranks, mode, case, run):
    """Each rank's shard, and the replicated factors, histories and flag on
    both ranks alike."""
    key = f"{case}-{run}-mode{mode}"
    for rank in range(2):
        _assert_same_routes(two_ranks[rank], key, run)
    replicated = ("b", "c") if mode == 1 else ("a", "b")
    for f in (*replicated, "err_hist", "rre_hist", "done", "mu", "k", "o_full"):
        want = two_ranks[0][f"{key}/device/{f}"]
        assert np.array_equal(_bits(two_ranks[1][f"{key}/device/{f}"]), _bits(want)), f
    assert two_ranks[0][f"{key}/device/o"].shape[mode - 1 if mode == 1 else 2] == SHAPE[0 if mode == 1 else 2] // 2


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_sharded(case: str, run: str, mode: int, world: int) -> dict:
    cfg, d, mask, origin, _init = _inputs(case, run)
    with jax.enable_x64(cfg.dtype == "float64"):
        res = j_sharded(jnp.asarray(d), JConfig(**dataclasses.asdict(cfg)), j_make_mesh(n_slab=world),
                        shard_tensor_mode=mode, mask=None if mask is None else jnp.asarray(mask),
                        origin=jnp.asarray(origin))
        return {f: np.asarray(getattr(res, f)) for f in ("err_hist", "rre_hist", "o", "n_iters")}


def _tolerance(case: str) -> dict:
    if case == "bf16_storage":
        return dict(rtol=2e-2, atol=1e-4)
    return dict(rtol=1e-8, atol=0.0) if case == "f64" else dict(rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("run", SPAWNED_RUNS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", [1, 3], ids=["mode1", "mode3"])
@pytest.mark.parametrize("world", [1, 2], ids=["one_rank", "two_ranks"])
def test_device_form_matches_jax_sharded(mesh1, two_ranks, world, mode, case, run):
    """The device form's sharded solve against the reference's, from the
    reference's init: the histories, the iteration count and O. Both loops
    take one iteration a step whatever `cfg.unroll`, so an early stop comes
    at the reference's iteration, and O is compared in every case."""
    key = f"{case}-{run}-mode{mode}"
    got = arrays_of(key, _one_rank(mesh1, case, run, mode)) if world == 1 else two_ranks[0]
    want = _jax_sharded(case, run, mode, world)
    tol = _tolerance(case)
    n, n_jax = int(got[f"{key}/device/k"]), int(want["n_iters"])
    assert n == n_jax
    for hist in ("err_hist", "rre_hist"):
        mine = got[f"{key}/device/{hist}"]
        assert mine.shape == want[hist].shape == (MAX_ITER,)
        np.testing.assert_allclose(mine[:n], want[hist][:n], err_msg=f"{hist} vs JAX sharded", **tol)
        assert np.isnan(mine[n:]).all()
    if case != "bf16_storage":
        o_tol = (dict(rtol=1e-6, atol=1e-8 * np.abs(want["o"]).max()) if case == "f64"
                 else dict(rtol=2e-2, atol=2e-3))
        np.testing.assert_allclose(got[f"{key}/device/o_full"], want["o"], err_msg="O vs JAX sharded", **o_tol)


# ---------------------------------------------------------------------------
# route choice and the counts under a capture
# ---------------------------------------------------------------------------


def test_route_choice_follows_the_groups_backend(mesh1, monkeypatch):
    """On a CUDA device the graph route is taken without a shard and with a
    NCCL group's collective; a gloo group, `_eager` and the CPU take the
    eager loop."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    coll = SlabCollective(mesh1.get_group("slab"), 1)
    assert not coll.capturable
    assert admm._graph_route(cuda, None) and not admm._graph_route(cuda, coll)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    assert coll.capturable and admm._graph_route(cuda, coll)
    assert not admm._graph_route(cuda, coll, eager=True) and not admm._graph_route(cpu, coll)
    assert not admm._graph_route(cpu, None)


@pytest.mark.parametrize("eager", [False, True], ids=["graph", "eager"])
def test_local_solve_hands_the_route_and_the_shard_to_run_admm(mesh1, monkeypatch, eager):
    """`_local_solve(..., _eager=...)` reaches the route choice, and the
    graph route gets the shard: `_run_device_form(..., graphs=True,
    shard=coll)`."""
    seen = []
    monkeypatch.setattr(admm, "_graph_route", lambda device, shard, eager: seen.append((shard, eager)) or not eager)

    def device_form(d, state, cfg, *args, graphs, shard=None):
        seen.append((graphs, shard))
        return state._replace(k=cfg.max_iter)

    monkeypatch.setattr(admm, "_run_device_form", device_form)
    cfg, d, mask, origin, init = _inputs("f32", "unroll1")
    coll = SlabCollective(mesh1.get_group("slab"), 1)
    _state, _bounds, audit = sharded_admm._local_solve(d, cfg, coll, mask, origin, init, torch.device("cpu"),
                                                       _eager=eager)
    assert seen[0] == (coll, eager)
    if eager:
        assert len(seen) == 1 and audit["n_iters"] == MAX_ITER and audit["per_iter"]["calls"] == 4
    else:
        assert seen[1] == (True, coll) and audit["n_iters"] == MAX_ITER


class _FakeGraph:
    """`torch.cuda.CUDAGraph`'s calls, on the CPU: the capture runs the
    captured function's Python once and a replay runs nothing."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


def test_collective_counts_are_the_replays_not_the_capture(mesh1, monkeypatch):
    """A capture that meets the collective's calls leaves its counts as they
    were; each replay adds them, as it adds the kernel's launches."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    coll = SlabCollective(mesh1.get_group("slab"), 1)
    coll.all_reduce(torch.ones(2))
    key = "elementwise_block[f32]"
    before = hopper_kernels.LAUNCHES[key]

    def block():
        for n in (5, 7):
            coll.all_reduce(torch.ones(n))
        hopper_kernels.LAUNCHES[key] += 1

    graph = hopper_kernels.CountedGraph(block, None, (coll.tally,))
    assert coll.counts() == {"calls": 1, "words": 2, "bytes": 8} and hopper_kernels.LAUNCHES[key] == before
    for _ in range(3):
        graph.replay()
    assert coll.counts() == {"calls": 7, "words": 38, "bytes": 152}
    assert hopper_kernels.LAUNCHES[key] == before + 3
    hopper_kernels.LAUNCHES[key] = before

    def failing():
        coll.all_reduce(torch.ones(4))
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        hopper_kernels.CountedGraph(failing, None, (coll.tally,))
    assert coll.counts() == {"calls": 7, "words": 38, "bytes": 152}
