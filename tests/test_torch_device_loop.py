"""PyTorch port, the device form of the TriTD-ADMM loop (`solvers/admm.py`):
the penalties and the counter as 0-d tensors, a block of `unroll`
iterations as one function of device tensors, the data-sized state taking
turns in two sets of buffers. On a CUDA device each block after the first
is one replay of a captured graph; here, on the CPU, the same blocks run
eagerly (`_run_device_form(..., graphs=False)`), and are held:

  * to the eager loop (host penalties and counter) bitwise, over whole
    solves: both are the same arithmetic on the same values;
  * to the JAX package's `tritd_admm` at the tolerances of
    `test_torch_admm.py` (float64 rtol 1e-8 on the histories, float32 rtol
    2e-4 on the first 20 iterations: summation order and float32 rounding);
  * the tensor penalty schedule to numpy's, and the tensor-penalty plain
    block to the host-penalty one, bitwise.

The checkpoint of a graph-route state needs the card and skips here; so
does the sharded solve on one NCCL rank, whose graph route captures the
four all_reduce calls of an iteration and is held bitwise to its eager loop
(`_local_solve(..., _eager=True)`), with the kernel once an iteration
through the pointer entry and max_iter + 1 synchronizing calls (one
iteration a step, as the reference's sharded loop); and so does the batch
in one loop on that rank (`tritd_admm_batch_sharded`): the kernel's batched
entry bitwise its pointer entry launched on each entry alone, one batched
launch an iteration, max_iter + 1 synchronizing calls, each entry held to
its serial solve (`_serial=True`).
JAX is imported only by the test that calls it, so that the rest of the file
also runs on a machine with the card and without JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops.narrow import narrow_cast  # noqa: E402
from tritd_tpu_torch.solvers import admm, init_factors, init_state, run_admm  # noqa: E402
from tritd_tpu_torch.utils import checkpoint  # noqa: E402
from tritd_tpu_torch.utils.config import COMPLETION_TRITD, VIDEO_TRITD  # noqa: E402

SHAPE = (12, 10, 14)
RANK = 3
STATE_FIELDS = ("a", "b", "c", "o", "e", "y_l", "y_o", "t", "err_hist", "rre_hist", "done")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=0):
    """Low-TriTD-rank truth + noise + sparse spikes, 10% missing, zero-filled."""
    rng = np.random.default_rng(seed)
    n1, n2, n3 = SHAPE
    a = rng.standard_normal((n1, RANK, RANK))
    b = rng.standard_normal((RANK, n2, RANK))
    c = rng.standard_normal((RANK, RANK, n3))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = 10.0 * x / np.sqrt(np.mean(x**2)) + 0.1 * rng.standard_normal(SHAPE)
    x = x + (rng.random(SHAPE) < 0.02) * 20.0
    mask = rng.random(SHAPE) >= 0.1
    return x, np.where(mask, x, 0.0), mask


def _init(dtype, seed=0):
    """Standard-normal factors drawn with numpy."""
    rng = np.random.default_rng(seed)
    n1, n2, n3 = SHAPE
    return [rng.standard_normal(s).astype(dtype) for s in ((n1, RANK, RANK), (RANK, n2, RANK), (RANK, RANK, n3))]


def _solve(cfg, y, mask, origin, init, route):
    """`run_admm` from `init_state` as `tritd_admm` calls it, on the eager
    loop or on the device form's blocks."""
    dtype = cfg.torch_dtype()
    d = torch.from_numpy(y).to(dtype)
    norm_d = torch.linalg.vector_norm(d)
    origin = torch.from_numpy(origin).to(dtype)
    norm_origin = torch.linalg.vector_norm(origin)
    state = init_state(d, cfg, init)
    d = narrow_cast(d, cfg.torch_storage_dtype())
    mask = torch.from_numpy(mask) if cfg.masked else None
    if route == "eager":
        return run_admm(d, state, cfg, mask=mask, origin=origin, norm_d=norm_d, norm_origin=norm_origin)
    return admm._run_device_form(d, state, cfg, mask, origin, norm_d, norm_origin, graphs=False)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.detach()
    if x.dim() == 0:
        x = x.reshape(1)
    return x.contiguous().view(torch.uint8)


BITWISE_CASES = {
    "f32": dict(),
    "f64": dict(dtype="float64"),
    "masked": dict(masked=True),
    "bf16_storage": dict(storage_dtype="bfloat16"),
    "masked_bf16_storage": dict(masked=True, storage_dtype="bfloat16"),
}


@pytest.mark.parametrize("tol", [0.0, 2e-2], ids=["tol0", "early_stop"])
@pytest.mark.parametrize("unroll", [1, 4], ids=["unroll1", "unroll4"])
@pytest.mark.parametrize("case", list(BITWISE_CASES))
def test_device_form_is_the_eager_loop_bitwise(case, unroll, tol):
    """A whole solve: every field of the final state, the histories and the
    penalties in the same bits; with tol 2e-2 both stop early, at the same
    block."""
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=40, tol=tol, unroll=unroll,
                              **BITWISE_CASES[case])
    x, y, mask = _problem()
    init = _init(cfg.np_dtype().type)
    eager = _solve(cfg, y, mask, x, init, "eager")
    device = _solve(cfg, y, mask, x, init, "device")
    assert device.k == eager.k and isinstance(device.k, int)
    if tol:
        assert eager.k < cfg.max_iter and bool(eager.done)
    else:
        assert eager.k == -(-cfg.max_iter // unroll) * unroll
    for mu in ("mu_l", "mu_o"):
        got, want = getattr(device, mu), getattr(eager, mu)
        assert type(got) is type(want) is cfg.np_dtype().type and got.tobytes() == want.tobytes()
    for f in STATE_FIELDS:
        got, want = getattr(device, f), getattr(eager, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert torch.equal(_bits(got), _bits(want)), f


def test_device_form_prints_the_eager_disp_lines(capsys):
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=23, tol=0.0, unroll=4, disp=True)
    x, y, mask = _problem()
    init = _init(np.float32)
    _solve(cfg, y, mask, x, init, "eager")
    eager = capsys.readouterr().out
    _solve(cfg, y, mask, x, init, "device")
    device = capsys.readouterr().out
    assert eager == device and eager.count("Iter ") == 2 and "Iter 20, errL=" in eager


JAX_CASES = {
    "f64": (dict(dtype="float64", max_iter=60), True),
    "f64_masked": (dict(dtype="float64", max_iter=60, masked=True), True),
    "f64_unroll3": (dict(dtype="float64", max_iter=40, unroll=3), True),
    "f32": (dict(max_iter=20, tol=0.0), False),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_device_form_matches_jax(case, monkeypatch):
    # the reference on the CPU, also where JAX could take a card: set before
    # JAX first picks its backend
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from tritd_tpu.solvers import TriTDConfig as JConfig
    from tritd_tpu.solvers import tritd_admm as j_tritd_admm
    from tritd_tpu.solvers.admm import init_factors as j_init_factors

    fields, x64 = JAX_CASES[case]
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, **fields)
    x, y, mask = _problem()
    np_dt = np.float64 if x64 else np.float32
    with jax.enable_x64(x64):
        init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), SHAPE, RANK, np_dt)]
        jres = j_tritd_admm(jnp.asarray(y, np_dt), JConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0),
                            mask=jnp.asarray(mask) if cfg.masked else None, origin=jnp.asarray(x, np_dt))
        want = {f: np.asarray(getattr(jres, f)) for f in ("err_hist", "rre_hist", "o", "n_iters")}
    got = _solve(cfg, y, mask, x, init, "device")
    n = int(want["n_iters"])
    assert min(got.k, cfg.max_iter) == n
    for key in ("err_hist", "rre_hist"):
        hist = getattr(got, key)[: cfg.max_iter].numpy()
        if x64:
            np.testing.assert_allclose(hist[:n], want[key][:n], rtol=1e-8)
            assert np.isnan(hist[n:]).all()
        else:
            np.testing.assert_allclose(hist, want[key], rtol=2e-4)
    if x64:
        o = got.o.numpy()
        np.testing.assert_allclose(o, want["o"], rtol=1e-6, atol=1e-8 * np.abs(want["o"]).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("preset", ["completion", "video"])
def test_tensor_penalty_schedule_is_numpys(preset, dtype):
    """mu annealed on 0-d tensors equals the numpy schedule bit for bit,
    through the cap (reached near iteration 62 at rho 1.25, 76 at 1.2)."""
    cfg = dataclasses.replace(COMPLETION_TRITD if preset == "completion" else VIDEO_TRITD, dtype=dtype)
    host = cfg.np_dtype().type(cfg.mu)
    dev = torch.full((), float(host), dtype=cfg.torch_dtype())
    capped = None
    for it in range(120):
        host, dev = admm.anneal(host, cfg), admm.anneal(dev, cfg)
        assert dev.dtype == cfg.torch_dtype() and dev.numpy().tobytes() == np.asarray(host).tobytes(), it
        if capped is None and host == cfg.np_dtype().type(cfg.mu * cfg.mu_cap_factor):
            capped = it
    assert capped is not None and 50 < capped < 90


@pytest.mark.parametrize("with_t", [False, True], ids=["no_t", "t"])
@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.float32), (torch.float64, torch.float64, torch.float64),
    (torch.float32, torch.bfloat16, torch.bfloat16), (torch.float64, torch.float64, torch.float16),
    (torch.float32, torch.float8_e5m2, torch.float8_e5m2)], ids=str)
def test_tensor_penalty_block_is_the_host_penalty_block(dtypes, with_t):
    cd, d_dt, s_dt = dtypes
    rng = np.random.default_rng(5)
    raw = [torch.from_numpy(rng.standard_normal((7, 9, 11)) * 3) for _ in range(5)]
    args = [narrow_cast(raw[0], d_dt), raw[1].to(cd), *(narrow_cast(x, s_dt) for x in raw[2:])]
    np_t = np.dtype(str(cd).removeprefix("torch.")).type
    mu_l, mu_o, mu_next = np_t(0.0015625), np_t(0.002), np_t(0.00244140625 * 1.25)
    host = hopper_kernels._block_torch(*args, mu_l, mu_o, 1.8, mu_next if with_t else None,
                                       compute_dtype=cd, store_dtype=s_dt)
    dev = hopper_kernels._block_torch(*args, *(torch.tensor(m) for m in (mu_l, mu_o)), 1.8,
                                      torch.tensor(mu_next) if with_t else None, compute_dtype=cd, store_dtype=s_dt)
    for i, (h, g) in enumerate(zip(host, dev)):
        if h is None:
            assert g is None and not with_t
            continue
        assert torch.equal(_bits(h), _bits(g)), i


def test_block_stores_into_given_buffers():
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(rng.standard_normal((5, 6, 7))) for _ in range(5)]
    out = tuple(torch.empty_like(args[0]) for _ in range(5))
    want = hopper_kernels.elementwise_block(*args, 0.5, 0.7, 1.8, mu_l_next=0.625)
    got = hopper_kernels.elementwise_block(*args, 0.5, 0.7, 1.8, mu_l_next=0.625, out=out)
    assert all(g is b for g, b in zip((*got[:4], got[6]), out))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="one of the block's inputs"):
        hopper_kernels.elementwise_block(*args, 0.5, 0.7, 1.8, mu_l_next=0.625, out=(args[2], *out[1:]))
    with pytest.raises(ValueError, match="t None exactly when no T'"):
        hopper_kernels.elementwise_block(*args, 0.5, 0.7, 1.8, out=out)
    with pytest.raises(ValueError, match="out buffer"):
        hopper_kernels.elementwise_block(*args, 0.5, 0.7, 1.8, mu_l_next=0.625,
                                         out=(out[0].float(), *out[1:]))


def test_graph_nodes_count_replays_not_the_capture():
    """The wrapper calls inside a capture are nodes: LAUNCHES is as it was
    after the block, and each replay adds the nodes."""
    key = "elementwise_block[f32]"
    before = dict(hopper_kernels.LAUNCHES)
    with hopper_kernels.graph_nodes() as nodes:
        hopper_kernels.LAUNCHES[key] += 3
    assert nodes == {key: 3} and hopper_kernels.LAUNCHES == before
    for _ in range(5):
        hopper_kernels.count_replay(nodes)
    assert hopper_kernels.LAUNCHES[key] == before[key] + 15
    hopper_kernels.LAUNCHES[key] = before[key]


def test_graph_nodes_count_pointer_launches_apart():
    """A capture's launches through the pointer entry are nodes too: each
    replay adds them to POINTER_LAUNCHES as well as to LAUNCHES, and the
    capture itself counts nothing in either."""
    key, ptr = "elementwise_block[c32_dbf16_sbf16_tbf16]", "elementwise_block_ptr[c32_dbf16_sbf16_tbf16]"
    before, before_ptr = dict(hopper_kernels.LAUNCHES), dict(hopper_kernels.POINTER_LAUNCHES)
    with hopper_kernels.graph_nodes() as nodes:
        hopper_kernels.LAUNCHES[key] += 2
        hopper_kernels.POINTER_LAUNCHES[ptr] += 2
    assert nodes == {key: 2, ptr: 2}
    assert hopper_kernels.LAUNCHES == before and hopper_kernels.POINTER_LAUNCHES == before_ptr
    for _ in range(3):
        hopper_kernels.count_replay(nodes)
    assert hopper_kernels.LAUNCHES[key] == before[key] + 6
    assert hopper_kernels.POINTER_LAUNCHES[ptr] == before_ptr[ptr] + 6
    hopper_kernels.reset_launch_counts()
    assert not any(hopper_kernels.LAUNCHES.values()) and not any(hopper_kernels.POINTER_LAUNCHES.values())


def _c_parameters(macro: str, name: str) -> list[str]:
    """The C parameter types of the function `name` in the entry macro."""
    import re

    params = re.search(re.escape(name) + r"\((.*?)\)\s*\{", macro, re.S).group(1)
    return [" ".join(p.split()[:-1]) for p in params.replace("\\", " ").split(",")]


def test_binding_takes_the_entry_macros_parameters():
    """The ctypes argument lists of both entries follow the C parameter
    lists of TRITD_BLOCK_ENTRY (a pointer as c_void_p, int64_t, int, and C
    as the compute dtype's ctype), so a change of the macro that the
    binding does not follow fails here, before the card."""
    import ctypes

    from tritd_tpu_torch.runtime import build, kernels

    src = (build.SRC_DIR / "elementwise_block.cuh").read_text()
    macro = src[src.index("#define TRITD_BLOCK_ENTRY"):]
    for scalar in (ctypes.c_float, ctypes.c_double):
        as_ctype = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "C": scalar}
        for name, pointer in (("int NAME", False), ("int NAME##_ptr", True)):
            want = [ctypes.c_void_p if "*" in p else as_ctype[p] for p in _c_parameters(macro, name)]
            assert kernels._block_argtypes(scalar, pointer) == want, name


def test_run_admm_takes_the_eager_loop_on_the_cpu(monkeypatch):
    called = []
    monkeypatch.setattr(admm, "_run_device_form", lambda *a, **k: called.append(1))
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=3)
    x, y, mask = _problem()
    res = _solve(cfg, y, mask, x, _init(np.float32), "eager")
    assert not called and res.k == 3 and isinstance(res.mu_l, np.float32)


@pytest.mark.cuda
def test_graph_route_checkpoint_resumes_bitwise(tmp_path):
    """A state the graph route returns, saved and loaded, resumes on the
    graph route to the bits of a run that never stopped."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graph route captures CUDA graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=RANK, max_iter=40, tol=0.0, unroll=3)
    x, y, mask = _problem()
    init = _init(np.float32)
    d = torch.from_numpy(y.astype(np.float32)).cuda()
    norm_d = torch.linalg.vector_norm(d)
    whole = run_admm(d, init_state(d, cfg, init), cfg, norm_d=norm_d)
    first = run_admm(d, init_state(d, cfg, init), dataclasses.replace(cfg, max_iter=20), norm_d=norm_d)
    assert first.k == 21 and isinstance(first.mu_l, np.float32)
    path = checkpoint.save_state(str(tmp_path / "step_000021.npz"), first)
    loaded = checkpoint.load_state(path, torch.float32, d=d)
    assert loaded.mu_l.tobytes() == first.mu_l.tobytes() and loaded.k == 21
    resumed = run_admm(d, loaded, cfg, norm_d=norm_d)
    assert resumed.k == whole.k and resumed.mu_l.tobytes() == whole.mu_l.tobytes()
    for f in STATE_FIELDS:
        assert torch.equal(_bits(getattr(resumed, f)), _bits(getattr(whole, f))), f


@pytest.fixture(scope="module")
def nccl_mesh():
    """This process as a one-rank NCCL group on the card, for the module's
    sharded cases (a second rank would need a second card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and CUDA graphs run on the card")
    import socket

    import torch.distributed as dist

    from tritd_tpu_torch.parallel import make_mesh
    from tritd_tpu_torch.parallel.distributed import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, backend="nccl", device="cuda:0",
                           timeout_s=120.0)
    try:
        yield make_mesh(device_type="cuda")
    finally:
        dist.destroy_process_group()


def _counting_syncs(fn, syncs: list):
    """`fn` that appends to `syncs` the synchronizing calls each call of it
    made (`torch.cuda.set_sync_debug_mode("warn")`)."""
    import warnings

    def watched(*args, **kwargs):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                # the warnings of the synchronizing calls; the mode's one-time notice that it is a
                # prototype also names synchronization
                syncs.append(sum("called a synchronizing" in str(w.message) for w in seen))

    return watched


def _sharded_route(mesh, y, cfg, mode, mask, eager, monkeypatch):
    """`_local_solve` on one route from one init, as `tritd_admm_sharded`
    calls it: the final state, the audit, the launches (all, and through
    the pointer entry) and the synchronizing calls inside `run_admm`."""
    from tritd_tpu_torch.parallel import sharded_admm

    real, syncs = sharded_admm.run_admm, []
    monkeypatch.setattr(sharded_admm, "run_admm", _counting_syncs(real, syncs))
    init = init_factors(torch.Generator().manual_seed(0), tuple(y.shape), cfg.rank, cfg.torch_dtype(), "cpu")
    hopper_kernels.reset_launch_counts()
    coll = sharded_admm.SlabCollective(mesh.get_group("slab"), mode)
    state, _bounds, audit = sharded_admm._local_solve(y, cfg, coll, mask, y, init, torch.device("cuda", 0),
                                                      _eager=eager)
    torch.cuda.synchronize()
    monkeypatch.setattr(sharded_admm, "run_admm", real)
    return (state, audit, {k: v for k, v in hopper_kernels.LAUNCHES.items() if v},
            {k: v for k, v in hopper_kernels.POINTER_LAUNCHES.items() if v}, syncs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "masked_bf16_storage"])
@pytest.mark.parametrize("unroll", [1, 3], ids=["unroll1", "unroll3"])
@pytest.mark.parametrize("mode", [1, 3], ids=["mode1", "mode3"])
def test_sharded_graph_route_is_the_eager_loop_bitwise(nccl_mesh, mode, unroll, case, monkeypatch):
    """The sharded solve on one NCCL rank at 20x16x24: the graph route (its
    four all_reduce calls an iteration captured) stores the eager loop's
    bits in every field and the penalties, launches the kernel once an
    iteration through the pointer entry, makes max_iter + 1 synchronizing
    calls (the stop flag before each iteration, one a step whatever
    `unroll`, as the reference's sharded loop; the penalties at the end),
    and counts the collective's calls as the eager loop does."""
    rng = np.random.default_rng(7)
    shape = (20, 16, 24)
    fields = BITWISE_CASES[case]
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=25, tol=0.0, unroll=unroll, **fields)
    y = (rng.standard_normal(shape) * 10).astype(np.float32)
    mask = rng.random(shape) >= 0.1 if cfg.masked else None
    if cfg.masked:
        y = np.where(mask, y, np.float32(0.0))
    graph, g_audit, g_launches, g_pointer, g_syncs = _sharded_route(nccl_mesh, y, cfg, mode, mask, False, monkeypatch)
    eager, e_audit, e_launches, e_pointer, _ = _sharded_route(nccl_mesh, y, cfg, mode, mask, True, monkeypatch)
    n = cfg.max_iter
    assert graph.k == eager.k == n and graph.mu_l.tobytes() == eager.mu_l.tobytes()
    assert g_launches == e_launches and len(g_launches) == 1 and sum(g_launches.values()) == n
    assert list(g_pointer.values()) == [n] and e_pointer == {}
    assert g_syncs == [cfg.max_iter + 1]
    assert g_audit["per_iter"] == e_audit["per_iter"] and g_audit["per_iter"]["calls"] == 4
    assert g_audit["setup"] == e_audit["setup"]
    for f in STATE_FIELDS:
        assert torch.equal(_bits(getattr(graph, f)), _bits(getattr(eager, f))), f


@pytest.mark.cuda
def test_sharded_entry_points_take_the_graph_route(nccl_mesh):
    """`tritd_admm_auto` is `tritd_admm_sharded` mode 1 bit for bit on the
    graph route, at unroll 1 (the sharded loop's step), and each entry of
    `tritd_admm_batch_sharded(..., _serial=True)` is the sharded solve of
    that entry: the kernel once an iteration, every launch through the
    pointer entry. The batch's own loop launches the batched entry once an
    iteration for both entries and nothing else."""
    from tritd_tpu_torch.parallel import tritd_admm_auto, tritd_admm_batch_sharded, tritd_admm_sharded

    rng = np.random.default_rng(8)
    shape = (20, 16, 24)
    y = (rng.standard_normal((2, *shape)) * 10).astype(np.float32)
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=12, tol=0.0)
    gen = torch.Generator().manual_seed(0)
    inits = [init_factors(gen, shape, cfg.rank, torch.float32, "cpu") for _ in range(2)]
    stacked = tuple(torch.stack(f) for f in zip(*inits))
    hopper_kernels.reset_launch_counts()
    sharded = [tritd_admm_sharded(y[i], cfg, nccl_mesh, origin=y[i], init=inits[i]) for i in range(2)]
    auto = tritd_admm_auto(y[0], cfg, nccl_mesh, origin=y[0], init=inits[0])
    serial = tritd_admm_batch_sharded(y, cfg, nccl_mesh, origin_batch=y, init=stacked, _serial=True)
    torch.cuda.synchronize()
    assert hopper_kernels.LAUNCHES["elementwise_block[f32]"] == 5 * 12
    assert hopper_kernels.POINTER_LAUNCHES["elementwise_block_ptr[f32]"] == 5 * 12
    for f in ("a", "b", "c", "o", "e", "err_hist", "rre_hist"):
        assert torch.equal(getattr(auto, f), getattr(sharded[0], f)), f
        for i in range(2):
            assert torch.equal(getattr(serial, f)[i], getattr(sharded[i], f)), (f, i)
    hopper_kernels.reset_launch_counts()
    tritd_admm_batch_sharded(y, cfg, nccl_mesh, origin_batch=y, init=stacked)
    torch.cuda.synchronize()
    assert {k: v for k, v in hopper_kernels.BATCH_LAUNCHES.items() if v} == {"elementwise_block_batch[f32]": 12}
    assert not any(hopper_kernels.LAUNCHES.values())


def _offset(x: torch.Tensor, off: int) -> torch.Tensor:
    """x copied into a buffer on the card that starts `off` elements before it."""
    view = torch.empty(x.numel() + off, dtype=x.dtype, device="cuda")[off:].view(x.shape)
    return view.copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "f64", "c32_de5m2_se5m2_te5m2", "c32_d32_sbf16_tbf16", "c64_d64_s64_tf16"])
@pytest.mark.parametrize("shape,offset", [((20, 16, 24), False), ((5, 7, 3), False), ((5, 7, 3), True)],
                         ids=["aligned", "ragged", "offset"])
def test_batched_entry_is_the_pointer_entry_per_entry(variant, shape, offset):
    """Three entries in one launch of the batched entry: every store and both
    sums of each bitwise the pointer entry's launch on that entry alone,
    also where n * itemsize is no multiple of 16 (the element path), and
    where every stream is a view that starts so far into its buffer that
    entry 0's addresses are not 16-byte aligned but entry 1's are (each
    entry takes the path its own addresses allow)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs on the card")
    cd, d_dt, s_dt, t_dt = next(k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    rng = np.random.default_rng(3)
    nb = 3
    with_t = d_dt == s_dt  # the masked variants take no T'
    n = int(np.prod(shape))
    narrowest = min(torch.empty((), dtype=x).element_size() for x in (cd, d_dt, s_dt) + ((t_dt,) if with_t else ()))
    off = (-n) % (16 // narrowest) if offset else 0
    assert off or not offset
    raw = [torch.from_numpy(rng.standard_normal((nb, *shape)) * 3) for _ in range(5)]
    d = _offset(narrow_cast(raw[0], d_dt).cuda(), off)
    l = _offset(raw[1].to(cd).cuda(), off)
    e, y_l, y_o = (_offset(narrow_cast(x, s_dt).cuda(), off) for x in raw[2:])
    mu_l, mu_o = (torch.tensor(v, dtype=cd, device="cuda") for v in ([0.7, 1.3, 2.9], [0.4, 0.9, 5.0]))
    mu_next = mu_l * 1.05 if with_t else None

    def outs():
        return [_offset(torch.zeros_like(e), off) for _ in range(4)] + \
            [_offset(torch.zeros_like(d, dtype=t_dt), off) if with_t else None]

    hopper_kernels.reset_launch_counts()
    got = hopper_kernels.elementwise_block_batch(d, l, e, y_l, y_o, mu_l, mu_o, 0.8, mu_l_next=mu_next,
                                                 t_dtype=t_dt if with_t else None, out=outs())
    assert hopper_kernels.BATCH_LAUNCHES[f"elementwise_block_batch[{variant}]"] == 1
    if offset:
        streams = [d, l, e, y_l, y_o, *(x for x in got[:4]), *([got[6]] if with_t else [])]
        assert not hopper_kernels.pointers_aligned(*(x[0].data_ptr() for x in streams))
        assert hopper_kernels.pointers_aligned(*(x[1].data_ptr() for x in streams))
    # the launch on one entry stores into views of batch-shaped buffers, so
    # that its pointers sit where the batch's do (an entry whose pointers are
    # not 16-byte aligned takes the one-element path, which sums in another
    # order than the vector path)
    bufs = outs()
    for i in range(nb):
        want = hopper_kernels.elementwise_block(d[i], l[i], e[i], y_l[i], y_o[i], mu_l[i], mu_o[i], 0.8,
                                                mu_l_next=None if mu_next is None else mu_next[i],
                                                t_dtype=t_dt if with_t else None,
                                                out=[None if b is None else b[i] for b in bufs])
        for j, w in enumerate(want):
            if w is not None:
                assert torch.equal(_bits(got[j][i]), _bits(w)), (i, j)
    assert hopper_kernels.POINTER_LAUNCHES[f"elementwise_block_ptr[{variant}]"] == nb


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [dict(tol=0.0), dict(tol=1e-2), dict(masked=True, storage_dtype="bfloat16",
                                                                          tol=0.0)],
                         ids=["tol0", "early_stop", "masked_bf16_storage"])
def test_batch_graph_route_is_the_serial_route(nccl_mesh, fields, monkeypatch):
    """Three entries on one NCCL rank at 20x16x24: the batched loop on the
    graph route launches the batched entry once an iteration and no single
    entry, reads the flags once before each iteration it runs and the
    penalties once (max_iter + 1 synchronizing calls at tol 0), and stores
    the bits of the same loop run eagerly. Each entry's iteration count is
    its serial solve's (`_serial=True`), its histories within the float32
    tolerances of tests/test_torch_parallel.py (rtol 2e-3, atol 1e-5; bf16
    storage 2e-2, 1e-4), L and O (but with bf16 storage) within rtol 2e-2,
    atol 2e-3 max|O|: cuBLAS picks other kernels for the batched products
    than for one entry's."""
    from tritd_tpu_torch.parallel import sharded_admm, tritd_admm_batch_sharded

    rng = np.random.default_rng(9)
    shape = (20, 16, 24)
    ys = []
    for scale in (1.0, 4.0, 20.0):  # low rank + noise + spikes, each entry falling at its own rate
        a, b, c = (rng.standard_normal(s) for s in ((shape[0], 3, 3), (3, shape[1], 3), (3, 3, shape[2])))
        x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
        x = scale * x / np.sqrt(np.mean(x**2)) + 0.02 * scale * rng.standard_normal(shape)
        ys.append(x + (rng.random(shape) < 0.02) * 5.0 * scale)
    y = np.stack(ys).astype(np.float32)
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=3, max_iter=25, **fields)
    mask = rng.random((3, *shape)) >= 0.1 if cfg.masked else None
    if cfg.masked:
        y = np.where(mask, y, np.float32(0.0))
    syncs: list = []
    real = sharded_admm.run_admm_batch
    monkeypatch.setattr(sharded_admm, "run_admm_batch", _counting_syncs(real, syncs))
    hopper_kernels.reset_launch_counts()
    audit: dict = {}
    got = tritd_admm_batch_sharded(y, cfg, nccl_mesh, mask_batch=mask, origin_batch=y, audit=audit)
    torch.cuda.synchronize()
    steps = audit["steps"]
    assert not any(hopper_kernels.LAUNCHES.values()) and sum(hopper_kernels.BATCH_LAUNCHES.values()) == steps
    # a read before each iteration run, one more if every entry stopped early, and the penalties
    assert syncs == [steps + (steps < cfg.max_iter) + 1]
    if not cfg.tol:
        assert syncs == [cfg.max_iter + 1]
    monkeypatch.setattr(sharded_admm, "_graph_route", lambda *args, **kwargs: False)
    eager = tritd_admm_batch_sharded(y, cfg, nccl_mesh, mask_batch=mask, origin_batch=y)
    want = tritd_admm_batch_sharded(y, cfg, nccl_mesh, mask_batch=mask, origin_batch=y, _serial=True)
    n = got.n_iters.tolist()
    assert n == eager.n_iters.tolist() == want.n_iters.tolist()
    if cfg.tol:
        assert len(set(n)) > 1 and max(n) < cfg.max_iter
    for f in ("a", "b", "c", "o", "e", "err_hist", "rre_hist"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(eager, f))), f
    h_tol = dict(rtol=2e-2, atol=1e-4) if cfg.storage_dtype else dict(rtol=2e-3, atol=1e-5)
    for i in range(3):
        for f in ("err_hist", "rre_hist"):
            torch.testing.assert_close(getattr(got, f)[i], getattr(want, f)[i], equal_nan=True, **h_tol,
                                       msg=lambda m, f=f, i=i: f"entry {i} {f}: {m}")
        # O not with bf16 storage, where a flipped rounding moves an element
        # by a bf16 step (tests/test_torch_parallel.py holds it so too)
        for f, g, w in (("L", *(admm.designs.triple_product(r.a[i], r.b[i], r.c[i]) for r in (got, want))),
                        ("o", got.o[i], want.o[i]))[: 1 if cfg.storage_dtype else 2]:
            torch.testing.assert_close(g, w, rtol=2e-2, atol=2e-3 * float(w.abs().max()),
                                       msg=lambda m, f=f, i=i: f"entry {i} {f}: {m}")
