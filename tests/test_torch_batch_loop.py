"""PyTorch port, a batch's entries in one loop (`solvers.admm.run_admm_batch`,
reached through `tritd_admm_batch_sharded`): the counterpart of the
reference's `jax.vmap` of its sharded `while_loop`
(`tritd_tpu/parallel/sharded_admm.py:376-429`). Here, on the CPU over gloo,
the batched device form runs without graphs and is held:

  * the batched plain block (`elementwise_block_batch` on CPU tensors) to
    `_block_torch` on each entry alone, bitwise: stores and both sums, in
    float32, float64, bf16 storage and masked;
  * the batched loop to the serial route (`_serial=True`: each entry solved
    on its own, as `tritd_admm_sharded` solves it), entry by entry in
    float64, at tol 0 and with early stops at different iterations: equal
    iteration counts, histories NaN past each entry's stop, every field at
    the stop bitwise or within rtol 1e-13;
  * to the JAX package's `tritd_admm_batch_sharded` from the reference's own
    init, at tests/test_torch_parallel.py's batch tolerances (float64 rtol
    1e-8 on the histories, bf16 storage rtol 2e-2 atol 1e-4): unroll 3 with
    early stops (the reference's loop takes one iteration a step whatever
    `unroll`), masked, and bf16 storage, on one data rank in this process
    and on two data ranks of spawned gloo workers
    (tests/torch_parallel_worker.py).

vmap's per-entry fallback is an error in every batched solve here, so no
operation of the batched sweep loops over the entries unseen. The batched
kernel entry's ctypes binding is held to the entry macro. The graph route,
its launches and its synchronizing calls need the card
(tests/test_torch_device_loop.py).
"""

import contextlib
import dataclasses
import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tritd_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from tritd_tpu.parallel import tritd_admm_batch_sharded as j_batch_sharded  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers.admm import init_factors as j_init_factors  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.parallel import make_mesh, sharded_admm, tritd_admm_batch_sharded  # noqa: E402
from tritd_tpu_torch.parallel.distributed import launch_local  # noqa: E402
from tritd_tpu_torch.solvers import admm  # noqa: E402
from tritd_tpu_torch.utils.config import COMPLETION_TRITD  # noqa: E402

SHAPE = (20, 16, 24)
RANK = 3
NB = 3
MAX_ITER = 30
SPAWN_TIMEOUT_S = 300.0
RESULT_FIELDS = ("a", "b", "c", "o", "e", "err_hist", "rre_hist")
# relative change of err that the early-stop solves stop at: each entry of
# _problem() at its own iteration, all before MAX_ITER
EARLY_TOL = 1e-2

# solves against the serial route, float64: name -> cfg fields; those with
# tol > 0 must stop entries at different iterations before MAX_ITER
SERIAL_CASES = {
    "tol0": dict(tol=0.0),
    "early_stop": dict(tol=EARLY_TOL),
    "masked_early_stop": dict(masked=True, tol=EARLY_TOL),
    "bf16_storage_early_stop": dict(storage_dtype="bfloat16", tol=EARLY_TOL),
    "bf16_einsum": dict(einsum_dtype="bfloat16", tol=0.0),
}
# against the JAX package: name -> cfg fields
JAX_CASES = {
    "unroll3_early_stop": dict(unroll=3, tol=EARLY_TOL),
    "masked": dict(masked=True, tol=0.0),
    "bf16_storage": dict(storage_dtype="bfloat16", tol=0.0),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _no_vmap_fallback():
    """vmap's warning that it loops over the entries of an operation with no
    batching rule ("There is a performance drop because we have not yet
    implemented the batching rule"), raised as an error; off by default."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def _problem(nb: int = NB):
    """`nb` entries of low-TriTD-rank truth + noise + sparse spikes, each of
    its own scale and noise (so that their errors fall at different rates),
    10% missing: (truth, data zero-filled where missing, mask), float64."""
    rng = np.random.default_rng(0)
    n1, n2, n3 = SHAPE
    xs, masks = [], []
    for i in range(nb):
        a = rng.standard_normal((n1, RANK, RANK))
        b = rng.standard_normal((RANK, n2, RANK))
        c = rng.standard_normal((RANK, RANK, n3))
        x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
        x = (1.0 + 4.0 * i) * x / np.sqrt(np.mean(x**2)) + 0.05 * (1 + 3 * i) * rng.standard_normal(SHAPE)
        xs.append(x + (rng.random(SHAPE) < 0.02) * 10.0)
        masks.append(rng.random(SHAPE) >= 0.1)
    x, mask = np.stack(xs), np.stack(masks)
    return x, np.where(mask, x, 0.0), mask


@pytest.fixture(scope="module")
def mesh1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the batched plain block
# ---------------------------------------------------------------------------

BLOCK_CASES = {
    "f32": (torch.float32, torch.float32, torch.float32, True),
    "f64": (torch.float64, torch.float64, torch.float64, True),
    "bf16_storage": (torch.float32, torch.bfloat16, torch.bfloat16, True),
    "masked": (torch.float32, torch.float32, torch.bfloat16, False),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_batched_plain_block_is_the_block_of_each_entry(case):
    """Every store and both sums of each entry bitwise `_block_torch` on that
    entry alone with its 0-d penalties; also through `out=` buffers."""
    cd, d_dt, s_dt, with_t = BLOCK_CASES[case]
    rng = np.random.default_rng(5)
    shape = (NB, *SHAPE)
    d, l, e, y_l, y_o = (torch.from_numpy(rng.standard_normal(shape) * 3) for _ in range(5))
    d, l = d.to(d_dt), l.to(cd)
    e, y_l, y_o = (hopper_kernels.narrow_cast(x, s_dt) for x in (e, y_l, y_o))
    mu_l, mu_o = (torch.tensor(v, dtype=cd) for v in ([0.7, 1.3, 2.9], [0.4, 0.9, 5.0]))
    mu_next = mu_l * 1.05 if with_t else None
    got = hopper_kernels.elementwise_block_batch(d, l, e, y_l, y_o, mu_l, mu_o, 0.8, mu_l_next=mu_next)
    outs = [torch.empty_like(e) for _ in range(4)] + [torch.empty_like(e) if with_t else None]
    into = hopper_kernels.elementwise_block_batch(d, l, e, y_l, y_o, mu_l, mu_o, 0.8, mu_l_next=mu_next, out=outs)
    assert got[4].shape == got[5].shape == (NB,) and (got[6] is None) == (not with_t)
    for i in range(NB):
        want = hopper_kernels._block_torch(d[i], l[i], e[i], y_l[i], y_o[i], mu_l[i], mu_o[i], 0.8,
                                           None if mu_next is None else mu_next[i], compute_dtype=cd,
                                           store_dtype=s_dt)
        for res in (got, into):
            for j, w in enumerate(want):
                if w is not None:
                    assert torch.equal(res[j][i], w), (i, j)
    assert all(into[j] is outs[j] for j in range(4))


def test_batched_block_takes_one_penalty_an_entry():
    x = torch.zeros((NB, 4, 5, 6))
    mu = torch.ones(NB)
    with pytest.raises(ValueError, match="mu_o must be a tensor of shape"):
        hopper_kernels.elementwise_block_batch(x, x, x, x, x, mu, 1.0, 0.1)
    with pytest.raises(ValueError, match="mu_l must be a tensor of shape"):
        hopper_kernels.elementwise_block_batch(x, x, x, x, x, torch.ones(NB + 1), mu, 0.1)


def test_binding_takes_the_batched_entrys_parameters():
    """The ctypes argument list of NAME_batch follows its C parameter list
    in TRITD_BLOCK_ENTRY, as tests/test_torch_device_loop.py holds the other
    two entries."""
    import ctypes
    import re

    from tritd_tpu_torch.runtime import build, kernels

    src = (build.SRC_DIR / "elementwise_block.cuh").read_text()
    macro = src[src.index("#define TRITD_BLOCK_ENTRY"):]
    params = re.search(re.escape("int NAME##_batch") + r"\((.*?)\)\s*\{", macro, re.S).group(1)
    types = [" ".join(p.split()[:-1]) for p in params.replace("\\", " ").split(",")]
    assert types[13] == "int" and params.split(",")[13].split()[-1] == "n_batch"
    for scalar in (ctypes.c_float, ctypes.c_double):
        as_ctype = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "C": scalar}
        want = [ctypes.c_void_p if "*" in p else as_ctype[p] for p in types]
        assert kernels._block_argtypes(scalar, pointer=False, batch=True) == want


def test_vmap_fallback_is_an_error_here():
    """The guard the batched solves run under catches a per-entry loop: an
    operation with no batching rule fails under it."""
    with _no_vmap_fallback(), pytest.raises(UserWarning, match="batching rule for aten::histc"):
        torch.func.vmap(lambda x: torch.histc(x, bins=4))(torch.rand(2, 3))


# ---------------------------------------------------------------------------
# the batched loop against the serial route
# ---------------------------------------------------------------------------


def _cfg(fields, dtype="float64"):
    return dataclasses.replace(COMPLETION_TRITD, **{**dict(rank=RANK, max_iter=MAX_ITER, dtype=dtype), **fields})


@pytest.mark.parametrize("case", list(SERIAL_CASES))
def test_batched_loop_is_the_serial_route(mesh1, case):
    cfg = _cfg(SERIAL_CASES[case])
    x, y, mask = _problem()
    kw = dict(mask_batch=mask if cfg.masked else None, origin_batch=x, device="cpu")
    audit, serial_audit = {}, {}
    with _no_vmap_fallback():
        got = tritd_admm_batch_sharded(y, cfg, mesh1, audit=audit, **kw)
    want = tritd_admm_batch_sharded(y, cfg, mesh1, _serial=True, audit=serial_audit, **kw)
    n = got.n_iters.tolist()
    assert n == want.n_iters.tolist() == audit["n_iters"] == serial_audit["n_iters"]
    if cfg.tol:
        assert len(set(n)) > 1 and max(n) < MAX_ITER, n
    else:
        assert n == [MAX_ITER] * NB
    assert audit["steps"] == max(n) and serial_audit["steps"] == sum(n)
    # one loop makes one entry's four calls, each carrying every entry's sums
    assert audit["per_iter"]["calls"] == serial_audit["per_iter"]["calls"] == 4
    assert audit["per_iter"]["words"] == NB * serial_audit["per_iter"]["words"]
    for f in RESULT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape and g.dtype == w.dtype, f
        torch.testing.assert_close(g, w, rtol=1e-13, atol=0, equal_nan=True, msg=lambda m, f=f: f"{f}: {m}")
    for i in range(NB):
        assert torch.isnan(got.err_hist[i, n[i]:]).all() and torch.isfinite(got.err_hist[i, :n[i]]).all()


def test_batch_takes_the_batched_loop_by_default(mesh1, monkeypatch):
    """`tritd_admm_batch_sharded` runs one batched `_local_solve` and in it
    one `run_admm_batch` for its entries, off the graph route on the CPU;
    `_serial=True` runs `_local_solve` per entry instead."""
    seen = []
    real_batch, real_local = admm.run_admm_batch, sharded_admm._local_solve

    def batch(d, state, cfg, shard, **kw):
        seen.append(("batch", tuple(d.shape), kw["graphs"]))
        return real_batch(d, state, cfg, shard, **kw)

    def local(*args, **kw):
        seen.append(("local", kw.get("batched", False)))
        return real_local(*args, **kw)

    monkeypatch.setattr(sharded_admm, "run_admm_batch", batch)
    monkeypatch.setattr(sharded_admm, "_local_solve", local)
    _x, y, _mask = _problem()
    cfg = _cfg(dict(tol=0.0, max_iter=3))
    tritd_admm_batch_sharded(y, cfg, mesh1, device="cpu")
    assert seen == [("local", True), ("batch", (NB, *SHAPE), False)]
    seen.clear()
    tritd_admm_batch_sharded(y, cfg, mesh1, device="cpu", _serial=True)
    assert seen == [("local", False)] * NB


def test_batched_loop_wants_histories_one_iteration_a_step(mesh1):
    _x, y, _mask = _problem()
    cfg = _cfg(dict(tol=0.0, max_iter=4, unroll=3))
    d = torch.from_numpy(y)
    state = admm.init_state(d, cfg, tuple(torch.zeros((NB, *s), dtype=torch.float64) for s in
                                          ((SHAPE[0], RANK, RANK), (RANK, SHAPE[1], RANK), (RANK, RANK, SHAPE[2]))))
    coll = sharded_admm.SlabCollective(mesh1.get_group("slab"), 1)
    with pytest.raises(ValueError, match="one iteration a step"):
        admm.run_admm_batch(d, state, cfg, coll, norm_d=torch.ones(NB, dtype=torch.float64))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax_inputs(case: str, nb: int):
    """(cfg, d, mask, origin, init) of a JAX case, numpy; the init is the
    reference's own: split(PRNGKey(0), nb), vmapped, at the (unpadded:
    one slab) shape."""
    cfg = _cfg(JAX_CASES[case])
    x, y, mask = _problem(nb)
    with jax.enable_x64(True):
        keys = jax.random.split(jax.random.PRNGKey(0), nb)
        init = jax.vmap(lambda k: j_init_factors(k, SHAPE, RANK, np.float64))(keys)
        init = tuple(np.asarray(u) for u in init)
    return cfg, y, mask if cfg.masked else None, x, init


def _jax_batch(case: str, nb: int, n_data: int) -> dict:
    cfg, d, mask, origin, _init = _jax_inputs(case, nb)
    with jax.enable_x64(True):
        res = j_batch_sharded(jnp.asarray(d), JConfig(**dataclasses.asdict(cfg)), j_make_mesh(n_slab=1, n_data=n_data),
                              mask_batch=None if mask is None else jnp.asarray(mask), origin_batch=jnp.asarray(origin))
        return {f: np.asarray(getattr(res, f)) for f in res._fields}


def _against_jax(got: dict, want: dict, case: str, nb: int) -> None:
    tol = dict(rtol=2e-2, atol=1e-4) if "bf16" in case else dict(rtol=1e-8, atol=0.0)
    n = [int(v) for v in got["n_iters"]]
    assert n == [int(v) for v in want["n_iters"]]
    if JAX_CASES[case]["tol"]:
        assert len(set(n)) > 1 and max(n) < MAX_ITER, n
    for i in range(nb):
        for hist in ("err_hist", "rre_hist"):
            mine = got[hist][i]
            assert mine.shape == want[hist][i].shape == (MAX_ITER,)
            np.testing.assert_allclose(mine[:n[i]], want[hist][i][:n[i]], err_msg=f"{hist}[{i}] vs JAX", **tol)
            assert np.isnan(mine[n[i]:]).all()
        if "bf16" not in case:
            o_tol = dict(rtol=1e-6, atol=1e-8 * np.abs(want["o"][i]).max())
            np.testing.assert_allclose(got["o"][i], want["o"][i], err_msg=f"O[{i}] vs JAX", **o_tol)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_batched_loop_matches_jax_on_one_data_rank(mesh1, case):
    cfg, d, mask, origin, init = _jax_inputs(case, NB)
    with _no_vmap_fallback():
        res = tritd_admm_batch_sharded(d, cfg, mesh1, mask_batch=mask, origin_batch=origin, init=init, device="cpu")
    got = {f: np.asarray(torch.as_tensor(getattr(res, f))) for f in res._fields}
    _against_jax(got, _jax_batch(case, NB, 1), case, NB)


@pytest.fixture(scope="module")
def two_data_ranks(tmp_path_factory):
    """Rank 0's results of every JAX case on a 2 x 1 mesh of spawned gloo
    workers, a batch of four: {case: {field: array}}."""
    tmp = tmp_path_factory.mktemp("two_data_ranks")
    spec, arrays = {}, {}
    for case in JAX_CASES:
        cfg, d, mask, origin, init = _jax_inputs(case, 4)
        spec[case] = dict(cfg=dataclasses.asdict(cfg), mode=1, n_data=2, batch=True, auto=False)
        arrays.update({f"{case}/d": d, f"{case}/origin": origin, f"{case}/a0": init[0], f"{case}/b0": init[1],
                       f"{case}/c0": init[2]})
        if mask is not None:
            arrays[f"{case}/mask"] = mask
    np.savez(tmp / "cases.npz", spec=json.dumps(spec), **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(Path(__file__).parent), os.environ.get("PYTHONPATH")])))
    launch_local(2, ["--cases", str(tmp / "cases.npz"), "--out", str(tmp / "out.npz")], timeout_s=SPAWN_TIMEOUT_S,
                 module="torch_parallel_worker", env=env)
    with np.load(tmp / "out.npz") as f:
        out = dict(f)
    return {case: {k.split("/", 1)[1]: v for k, v in out.items() if k.startswith(f"{case}/")} for case in JAX_CASES}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_batched_loop_matches_jax_on_two_data_ranks(two_data_ranks, case):
    _against_jax(two_data_ranks[case], _jax_batch(case, 4, 2), case, 4)
