"""PyTorch port, parallel layer: tritd_tpu_torch.parallel held against the
JAX sharded solvers (on the 8 virtual CPU devices) and against the port's
own single-device tritd_admm, on the same numpy data and the JAX-drawn init.

The cases are the explicit-path cases of tests/test_sharding.py and its two
`tritd_admm_auto` cases (the reference's GSPMD entry point, which the port
runs on the explicit mode-1 path; the reference draws its init at the padded
shape), on its SHAPE (22, 13, 17), whose n1 is no multiple of 4 or 8 and
whose n3 is none of 8, so slabs and frames are padded. The workers name the
mesh dimensions by keyword (`axis_name`, `data_axis`, `slab_axis`). World size 1 runs in this process over
a `dist.HashStore()`; world sizes 2, 4 and 8 run as gloo/CPU worker
processes (tests/torch_parallel_worker.py), one spawn per world size that
runs all its cases at both dtypes.

Tolerances, with reasons:
  * float64: rtol 1e-8 on err_hist/rre_hist against both. Sharding changes
    only the order of sums, and ADMM damps those ulps.
  * float32: rtol 2e-3, atol 1e-5, the reference's own
    (tests/test_sharding.py:32-36).
  * bf16 storage: rtol 2e-2, atol 1e-4 at either compute dtype, the
    reference's own (tests/test_sharding.py:217-260): an ulp from the order
    of sums can flip a rounding to bf16, which then feeds the trajectory.
"""

import concurrent.futures
import dataclasses
import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tritd_tpu.data.synthetic import random_tritd as j_random_tritd  # noqa: E402
from tritd_tpu.data.synthetic import sparse_outliers as j_sparse_outliers  # noqa: E402
from tritd_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from tritd_tpu.parallel import tritd_admm_auto as j_auto  # noqa: E402
from tritd_tpu.parallel import tritd_admm_batch_sharded as j_batch_sharded  # noqa: E402
from tritd_tpu.parallel import tritd_admm_sharded as j_sharded  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu_torch.parallel import (  # noqa: E402
    SlabCollective,
    make_mesh,
    pad_to_multiple,
    shard_bounds,
    tritd_admm_auto,
    tritd_admm_batch_sharded,
    tritd_admm_sharded,
)
from tritd_tpu_torch.parallel.distributed import launch_local  # noqa: E402
from tritd_tpu_torch.parallel.mesh import _pad_with  # noqa: E402
from tritd_tpu_torch.solvers import (  # noqa: E402
    TriTDConfig,
    admm_iteration,
    init_factors,
    init_state,
    tritd_admm,
    update_factors,
)

SHAPE = (22, 13, 17)
RANK = 2
SPAWN_TIMEOUT_S = 300.0

# case -> world size, layout and config; the keys follow tests/test_sharding.py
CASES = {
    "slab2": dict(world=2, cfg=dict(max_iter=25, tol=0.0)),
    "slab8": dict(world=8, cfg=dict(max_iter=25, tol=0.0)),
    "full_variant": dict(world=4, cfg=dict(max_iter=10, tol=0.0, variant="full")),
    "early_stop": dict(world=4, cfg=dict(max_iter=100, tol=1e-3)),
    "masked_mode1": dict(world=4, masked=True, cfg=dict(max_iter=20, tol=0.0, masked=True)),
    "masked_mode3": dict(world=4, mode=3, masked=True, cfg=dict(max_iter=20, tol=0.0, masked=True)),
    "rre_oracle": dict(world=4, origin=True, cfg=dict(max_iter=15, tol=0.0)),
    "mode3_frames": dict(world=8, mode=3, cfg=dict(max_iter=20, tol=0.0)),
    "bf16_storage": dict(world=4, cfg=dict(max_iter=25, tol=0.0, storage_dtype="bfloat16")),
    "batch_dp_tp": dict(world=8, n_data=2, batch=True, cfg=dict(max_iter=12, tol=0.0)),
    "batch_masked_origin": dict(world=8, n_data=2, batch=True, masked=True, origin=True,
                                cfg=dict(max_iter=10, tol=0.0, masked=True)),
    "batch_bf16_storage": dict(world=8, n_data=2, batch=True,
                               cfg=dict(max_iter=15, tol=0.0, storage_dtype="bfloat16")),
    "auto": dict(world=8, auto=True, cfg=dict(max_iter=15, tol=0.0)),
    "auto_masked_origin": dict(world=8, auto=True, masked=True, origin=True,
                               cfg=dict(max_iter=20, tol=0.0, masked=True)),
}
DTYPES = ("float64", "float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """The problem, mask and stand-in truth of tests/test_sharding.py, as
    numpy float32 arrays."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    x, _ = j_random_tritd(k1, SHAPE, rank=RANK)
    d = np.array(x + j_sparse_outliers(k2, SHAPE, density=0.05, magnitude=4.0))
    mask = np.array(jax.random.uniform(jax.random.PRNGKey(3), SHAPE) > 0.15)
    return d, mask


def _inputs(name, dtype, problem):
    """(d, mask, origin, init, cfg fields) of a case at a dtype, as numpy.
    The init is the reference's own draw: at the unpadded shape from
    PRNGKey(0); for `tritd_admm_auto`, whose single-device solve sees the
    padded tensor, at the padded shape from PRNGKey(0); for a batch, as
    `_batch_sharded_run` draws it, at the padded shape from
    split(PRNGKey(0), nb)."""
    case = CASES[name]
    d, mask = problem
    np_dt = np.dtype(dtype)
    n_slab = case["world"] // case.get("n_data", 1)
    with jax.enable_x64(dtype == "float64"):
        if case.get("batch"):
            d = np.stack([d, d * 0.5])
            mask = np.stack([mask, mask])
            n1p = -(-SHAPE[0] // n_slab) * n_slab
            keys = jax.random.split(jax.random.PRNGKey(0), 2)
            init = jax.vmap(lambda k: j_init_factors(k, (n1p, *SHAPE[1:]), RANK, np_dt))(keys)
        elif case.get("auto"):
            n1p = -(-SHAPE[0] // n_slab) * n_slab
            init = j_init_factors(jax.random.PRNGKey(0), (n1p, *SHAPE[1:]), RANK, np_dt)
        else:
            init = j_init_factors(jax.random.PRNGKey(0), SHAPE, RANK, np_dt)
        init = tuple(np.asarray(u) for u in init)
    origin = None
    if case.get("origin"):
        origin = (d if case.get("batch") else d * 0.9).astype(np_dt)
    if case.get("masked"):
        d = np.where(mask, d, 0.0)
    else:
        mask = None
    return d.astype(np_dt), mask, origin, init, dict(rank=RANK, dtype=dtype, **case["cfg"])


@pytest.fixture(scope="module")
def spawned(problem, tmp_path_factory):
    """`spawned(world)` -> the worker's .npz of that world size as a dict;
    the workers are spawned at the first call for a world size."""
    done = {}

    def get(world):
        if world in done:
            return done[world]
        tmp = tmp_path_factory.mktemp(f"world{world}")
        spec, arrays = {}, {}
        for name, case in CASES.items():
            if case["world"] != world:
                continue
            for dtype in DTYPES:
                d, mask, origin, init, cfg = _inputs(name, dtype, problem)
                key = f"{name}-{dtype}"
                spec[key] = dict(cfg=cfg, mode=case.get("mode", 1), n_data=case.get("n_data", 1),
                                 batch=bool(case.get("batch")), auto=bool(case.get("auto")))
                arrays.update({f"{key}/d": d, f"{key}/a0": init[0], f"{key}/b0": init[1], f"{key}/c0": init[2]})
                if mask is not None:
                    arrays[f"{key}/mask"] = mask
                if origin is not None:
                    arrays[f"{key}/origin"] = origin
        np.savez(tmp / "cases.npz", spec=json.dumps(spec), **arrays)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [str(Path(__file__).parent), os.environ.get("PYTHONPATH")])))
        launch_local(world, ["--cases", str(tmp / "cases.npz"), "--out", str(tmp / "out.npz")],
                     timeout_s=SPAWN_TIMEOUT_S, module="torch_parallel_worker", env=env)
        with np.load(tmp / "out.npz") as f:
            done[world] = dict(f)
        return done[world]

    return get


def _jax_sharded(name, dtype, problem):
    case = CASES[name]
    d, mask, origin, _init, cfg = _inputs(name, dtype, problem)
    with jax.enable_x64(dtype == "float64"):
        n_data = case.get("n_data", 1)
        mesh = j_make_mesh(n_slab=case["world"] // n_data, n_data=n_data)
        as_j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
        if case.get("batch"):
            res = j_batch_sharded(as_j(d), JConfig(**cfg), mesh, mask_batch=as_j(mask), origin_batch=as_j(origin))
        elif case.get("auto"):
            res = j_auto(as_j(d), JConfig(**cfg), mesh, mask=as_j(mask), origin=as_j(origin))
        else:
            res = j_sharded(as_j(d), JConfig(**cfg), mesh, shard_tensor_mode=case.get("mode", 1),
                            mask=as_j(mask), origin=as_j(origin))
        return {f: np.asarray(getattr(res, f)) for f in res._fields}


def _single_device(name, dtype, problem):
    """The port's tritd_admm on the same data and init; per batch entry. A
    batch's a0 and `tritd_admm_auto`'s are drawn at the padded shape and read
    by masked imputation, so their single-device twin solves the zero-padded
    problem (mask padded with True, origin with zeros), which is the same
    problem."""
    case = CASES[name]
    d, mask, origin, init, cfg = _inputs(name, dtype, problem)
    cfg = TriTDConfig(**cfg)
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    if not case.get("batch") and not case.get("auto"):
        res = tritd_admm(t(d), cfg, mask=t(mask), origin=t(origin), init=init)
        return [res]
    if case.get("auto"):  # one entry, as a batch of one
        d, mask, origin = (None if x is None else x[None] for x in (d, mask, origin))
        init = tuple(f[None] for f in init)
    out = []
    for i in range(d.shape[0]):
        n1p = init[0].shape[1]
        pad = lambda x, fill: None if x is None else t(_pad_with(x[i], 0, n1p, fill))  # noqa: E731
        res = tritd_admm(pad(d, 0), cfg, mask=pad(mask, True), origin=pad(origin, 0), init=tuple(f[i] for f in init))
        out.append(res)
    return out


def _tolerance(name, dtype):
    if "bf16" in name:
        return dict(rtol=2e-2, atol=1e-4)
    return dict(rtol=1e-8, atol=0.0) if dtype == "float64" else dict(rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax_and_single_device(name, dtype, problem, spawned):
    case = CASES[name]
    got = {k.split("/", 1)[1]: v for k, v in spawned(case["world"]).items() if k.startswith(f"{name}-{dtype}/")}
    want = _jax_sharded(name, dtype, problem)
    singles = _single_device(name, dtype, problem)
    tol = _tolerance(name, dtype)
    max_iter = case["cfg"]["max_iter"]
    assert got["err_hist"].dtype == got["o"].dtype == np.dtype(dtype)
    assert got["o"].shape == want["o"].shape and got["a"].shape == want["a"].shape
    entries = range(2) if case.get("batch") else [None]
    for i in entries:
        pick = (lambda x: x) if i is None else (lambda x, i=i: x[i])
        single = singles[0 if i is None else i]
        n = int(pick(got["n_iters"]))
        assert n == single.n_iters
        if dtype == "float64" or name != "early_stop":
            assert n == int(pick(want["n_iters"]))
        if name == "early_stop":
            assert 2 < n < max_iter
            assert np.isnan(pick(got["err_hist"])[n:]).all()
        else:
            assert n == max_iter
        m = min(n, int(pick(want["n_iters"])))
        for hist in ("err_hist", "rre_hist") if case.get("origin") else ("err_hist",):
            mine = pick(got[hist])
            assert mine.shape == (max_iter,)
            np.testing.assert_allclose(mine[:m], pick(want[hist])[:m], err_msg=f"{hist} vs JAX sharded", **tol)
            np.testing.assert_allclose(mine[:n], getattr(single, hist).numpy()[:n],
                                       err_msg=f"{hist} vs tritd_admm", **tol)
        if not case.get("origin"):
            # without origin the history is NaN, never the residual history
            assert np.isnan(pick(got["rre_hist"])).all()
        o_tol = dict(rtol=1e-6, atol=1e-8 * np.abs(want["o"]).max()) if tol["rtol"] == 1e-8 else dict(rtol=2e-2, atol=2e-3)
        if "bf16" not in name:
            np.testing.assert_allclose(pick(got["o"]), pick(want["o"]), err_msg="O vs JAX sharded", **o_tol)
            np.testing.assert_allclose(pick(got["o"]), single.o.numpy()[: SHAPE[0]], err_msg="O vs tritd_admm", **o_tol)
    # the counted all_reduce traffic of one iteration, against the design
    # budget (the reference's audit, bench_scaling.py:205-208)
    n1, n2, n3 = SHAPE
    r2 = RANK * RANK
    budget = 2 * r2 * r2 + ((n2 + n3) if case.get("mode", 1) == 1 else (n1 + n2)) * r2 + 8
    assert 0 < int(got["words_per_iter"]) <= budget


# ---------------------------------------------------------------------------
# world size 1, in this process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", [1, 3])
@pytest.mark.parametrize("fields", [dict(), dict(masked=True), dict(storage_dtype="bfloat16"),
                                    dict(einsum_dtype="bfloat16"), dict(unroll=4, tol=1e-3, max_iter=60)],
                         ids=["plain", "masked", "bf16_storage", "bf16_einsum", "unroll_early_stop"])
def test_one_shard_is_the_single_device_solver(mesh1, problem, mode, fields):
    """One shard reduces nothing: the histories are tritd_admm's to the last
    bits (the norms here are roots of sums of squares, there vector norms),
    and O is bitwise equal. The sharded loop tests the stop rule after every
    iteration, as the reference's sharded `while_loop` does whatever
    `unroll`: its twin is tritd_admm at unroll 1."""
    d, mask = problem
    cfg = TriTDConfig(**{**dict(rank=RANK, max_iter=20, tol=0.0, dtype="float64"), **fields})
    kw = dict(mask=torch.from_numpy(mask) if cfg.masked else None, origin=torch.from_numpy(d * 0.9))
    audit = {}
    got = tritd_admm_sharded(d.astype(np.float64), cfg, mesh1, shard_tensor_mode=mode, audit=audit, **kw)
    want = tritd_admm(torch.from_numpy(d.astype(np.float64)), dataclasses.replace(cfg, unroll=1), **kw)
    assert got.n_iters == want.n_iters == audit["n_iters"]
    torch.testing.assert_close(got.err_hist, want.err_hist, rtol=1e-13, atol=0, equal_nan=True)
    torch.testing.assert_close(got.rre_hist, want.rre_hist, rtol=1e-13, atol=0, equal_nan=True)
    torch.testing.assert_close(got.o, want.o, rtol=0, atol=0)
    assert audit["per_iter"]["calls"] == 4 and audit["setup"] == {"calls": 1, "words": 2, "bytes": 16}


def test_auto_keeps_tritd_admms_unroll(mesh1, problem):
    """The reference's auto is `tritd_admm` on the padded tensor, which tests
    the stop rule every `unroll` iterations: with unroll 4 and an early stop,
    `tritd_admm_auto` stops where the port's tritd_admm and the reference's
    auto do, a multiple of 4, past where the sharded solve stops."""
    d, _mask = problem
    cfg = TriTDConfig(rank=RANK, max_iter=60, tol=1e-3, dtype="float64", unroll=4)
    d = d.astype(np.float64)
    with jax.enable_x64(True):
        init = tuple(np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, RANK, np.float64))
        ref = j_auto(jnp.asarray(d), JConfig(**dataclasses.asdict(cfg)), j_make_mesh(n_slab=1))
        ref = {f: np.asarray(getattr(ref, f)) for f in ("err_hist", "n_iters")}
    got = tritd_admm_auto(d, cfg, mesh1, init=init, device="cpu")
    want = tritd_admm(torch.from_numpy(d), cfg, init=init)
    sharded = tritd_admm_sharded(d, cfg, mesh1, init=init, device="cpu")
    assert got.n_iters == want.n_iters == int(ref["n_iters"]) and got.n_iters % 4 == 0
    assert sharded.n_iters < got.n_iters < cfg.max_iter
    torch.testing.assert_close(got.err_hist, want.err_hist, rtol=1e-13, atol=0, equal_nan=True)
    np.testing.assert_allclose(got.err_hist.numpy()[: got.n_iters], ref["err_hist"][: got.n_iters], rtol=1e-8)
    torch.testing.assert_close(got.o, want.o, rtol=0, atol=0)


def test_sharded_masked_requires_mask(mesh1, problem):
    d, mask = problem
    with pytest.raises(ValueError, match="requires a mask"):
        tritd_admm_sharded(d, TriTDConfig(rank=RANK, max_iter=5, masked=True), mesh1)
    with pytest.raises(ValueError, match="masked=False"):
        tritd_admm_sharded(d, TriTDConfig(rank=RANK, max_iter=5), mesh1, mask=mask)
    with pytest.raises(ValueError, match="requires a mask_batch"):
        tritd_admm_batch_sharded(d[None], TriTDConfig(rank=RANK, masked=True), mesh1)
    with pytest.raises(ValueError, match="must be 1 or 3"):
        tritd_admm_sharded(d, TriTDConfig(rank=RANK, max_iter=5), mesh1, shard_tensor_mode=2)


def test_group_in_place_of_mesh_and_default_init(mesh1, problem):
    """A bare process group serves as well as the mesh, and the default init
    is tritd_admm's (seed 0 at the unpadded shape)."""
    d, _mask = problem
    cfg = TriTDConfig(rank=RANK, max_iter=5, tol=0.0)
    got = tritd_admm_sharded(torch.from_numpy(d), cfg, mesh1.get_group("slab"))
    want = tritd_admm(torch.from_numpy(d), cfg)
    torch.testing.assert_close(got.err_hist, want.err_hist, rtol=1e-6, atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked_origin"])
def test_auto_on_one_rank_is_the_sharded_solve(mesh1, problem, masked):
    """`tritd_admm_auto` is the explicit mode-1 path: on one rank (nothing
    padded) every field is the sharded solve's bit for bit, from numpy."""
    d, mask = problem
    cfg = TriTDConfig(rank=RANK, max_iter=12, tol=0.0, dtype="float64", masked=masked)
    kw = dict(mask=mask if masked else None, origin=d * 0.9, device="cpu")
    d = np.where(mask, d, 0.0) if masked else d
    got = tritd_admm_auto(d, cfg, mesh1, **kw)
    want = tritd_admm_sharded(d, cfg, mesh1, shard_tensor_mode=1, **kw)
    assert got.n_iters == want.n_iters == 12 and got.o.shape == SHAPE
    for f in ("a", "b", "c", "o", "e", "err_hist", "rre_hist"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0, equal_nan=True)


def test_mesh_dimensions_are_named_by_keyword(mesh1, problem):
    """`axis_name`, `data_axis` and `slab_axis` pick the mesh dimensions, as
    the reference's keywords do: on a mesh named ("dp", "tp") the solves are
    those of the ("data", "slab") mesh bitwise, and the default names raise."""
    from torch.distributed.device_mesh import init_device_mesh

    d, _mask = problem
    named = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "tp"))
    cfg = TriTDConfig(rank=RANK, max_iter=6, tol=0.0, dtype="float64")
    d = d.astype(np.float64)
    pairs = [
        (tritd_admm_sharded(d, cfg, named, axis_name="tp"), tritd_admm_sharded(d, cfg, mesh1)),
        (tritd_admm_auto(d, cfg, named, axis_name="tp"), tritd_admm_auto(d, cfg, mesh1)),
        (tritd_admm_batch_sharded(d[None], cfg, named, data_axis="dp", slab_axis="tp"),
         tritd_admm_batch_sharded(d[None], cfg, mesh1)),
    ]
    for got, want in pairs:
        for f in ("o", "err_hist"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=0, equal_nan=True)
    for call in (lambda: tritd_admm_sharded(d, cfg, named), lambda: tritd_admm_auto(d, cfg, named),
                 lambda: tritd_admm_batch_sharded(d[None], cfg, named, data_axis="dp")):
        with pytest.raises(KeyError, match="slab"):
            call()


def test_batch_on_one_rank_and_its_checks(mesh1, problem):
    d, _mask = problem
    cfg = TriTDConfig(rank=RANK, max_iter=30, tol=1e-2)
    batch = np.stack([d, d * 0.5, d * 2.0])
    res = tritd_admm_batch_sharded(batch, cfg, mesh1)
    gen = torch.Generator().manual_seed(0)
    assert res.err_hist.shape == (3, 30) and res.o.shape == (3, *SHAPE) and res.n_iters.shape == (3,)
    for i in range(3):  # each entry stops on its own, from its own draw of the one generator
        want = tritd_admm(torch.from_numpy(batch[i]), cfg, init=init_factors(gen, SHAPE, RANK, torch.float32, device="cpu"))
        assert int(res.n_iters[i]) == want.n_iters
        torch.testing.assert_close(res.err_hist[i], want.err_hist, rtol=1e-6, atol=0, equal_nan=True)
    assert len(set(res.n_iters.tolist())) > 1


class _ThreadShards:
    """A process group's stand-in for shards that run as threads of this
    process: `hook(i)` is shard i's collective, whose all_reduce waits for
    every shard's operand and returns their sum."""

    def __init__(self, shard_mode, n):
        self.shard_mode, self.slots = shard_mode, [None] * n
        self.barrier = threading.Barrier(n, timeout=60)

    def hook(self, index):
        outer = self

        class Hook:
            shard_mode = outer.shard_mode

            def all_reduce(self, x):
                outer.slots[index] = x
                outer.barrier.wait()
                total = sum(outer.slots[1:], outer.slots[0])
                outer.barrier.wait()
                return total

        return Hook()


@pytest.mark.parametrize("variant", ["hadamard", "full"])
@pytest.mark.parametrize("mode", [1, 3])
def test_update_factors_hook_places_the_sums(mode, variant):
    """The sweep on two uneven shards, their sums completed through the
    hook, lands on the single-device sweep, and the replicated factors are
    bitwise equal on both shards."""
    rng = np.random.default_rng(mode)
    t = torch.from_numpy(rng.standard_normal(SHAPE))
    a, b, c = (torch.from_numpy(rng.standard_normal(s)) for s in ((22, 2, 2), (2, 13, 2), (2, 2, 17)))
    cfg = TriTDConfig(rank=RANK, dtype="float64", variant=variant)
    want = update_factors(t, a, b, c, cfg)
    cuts = (slice(0, 9), slice(9, 22)) if mode == 1 else (slice(0, 7), slice(7, 17))
    shards = _ThreadShards(mode, 2)

    def sweep(i):
        s = cuts[i]
        if mode == 1:
            return update_factors(t[s], a[s], b, c, cfg, shard=shards.hook(i))
        return update_factors(t[..., s].contiguous(), a, b, c[..., s].contiguous(), cfg, shard=shards.hook(i))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        (a0, b0, c0), (a1, b1, c1) = (f.result(timeout=120) for f in [pool.submit(sweep, i) for i in range(2)])
    got = (torch.cat([a0, a1]), b0, c0) if mode == 1 else (a0, b0, torch.cat([c0, c1], dim=2))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-11)
    torch.testing.assert_close(b0, b1, rtol=0, atol=0)
    torch.testing.assert_close(*((c0, c1) if mode == 1 else (a0, a1)), rtol=0, atol=0)


def test_sharded_iteration_needs_the_whole_tensors_norm():
    d = torch.zeros(SHAPE)
    cfg = TriTDConfig(rank=RANK)
    state = init_state(d, cfg, init_factors(torch.Generator().manual_seed(0), SHAPE, RANK, torch.float32, device="cpu"))
    with pytest.raises(ValueError, match="norm_d"):
        admm_iteration(d, state, cfg, shard=_ThreadShards(1, 1).hook(0))


def test_mesh_helpers():
    x = np.arange(10.0).reshape(5, 2)
    padded, n = pad_to_multiple(x, 0, 4)
    assert n == 5 and padded.shape == (8, 2) and (padded[5:] == 0).all() and (padded[:5] == x).all()
    same, n = pad_to_multiple(x, 1, 2)
    assert same is x and n == 2
    t, n = pad_to_multiple(torch.ones(2, 3, dtype=torch.bfloat16), 1, 4)
    assert t.shape == (2, 4) and t.dtype == torch.bfloat16 and float(t[:, 3].sum()) == 0.0
    m = _pad_with(torch.zeros(3, 2, dtype=torch.bool), 0, 4, True)
    assert m.dtype == torch.bool and m[3].all() and not m[:3].any()
    assert [shard_bounds(24, 4, i) for i in range(4)] == [(0, 6), (6, 12), (12, 18), (18, 24)]
    with pytest.raises(ValueError, match="multiple"):
        shard_bounds(22, 4, 0)
    with pytest.raises(ValueError, match="outside"):
        shard_bounds(24, 4, 4)


def test_make_mesh_must_cover_the_group(mesh1):
    assert mesh1.mesh_dim_names == ("data", "slab") and mesh1["slab"].size() == 1
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(n_slab=2, device_type="cpu")
    with pytest.raises(ValueError, match="must be 1 or 3"):
        SlabCollective(mesh1.get_group("slab"), 2)


def test_launch_local_reports_a_failed_worker():
    with pytest.raises(RuntimeError, match=r"(?s)2 workers, a worker failed; exit codes \[.*unrecognized arguments: --no-such-flag"):
        launch_local(2, ["--no-such-flag"], timeout_s=120.0)
