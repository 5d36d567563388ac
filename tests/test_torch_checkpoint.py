"""PyTorch port, checkpoint/resume: utils/checkpoint.py and
solvers/checkpointed.py held against the JAX package, with checkpoints
carried across both ways (same .npz layout and field names), bitwise resume,
narrow storage, and the failure drill in a real process death.

Tolerances: float64 trajectories across packages rtol 1e-8 (as
test_torch_admm.py: the same program up to summation order); a resume
within one package on one device is bitwise (rtol 0, atol 0); a checkpoint
that round-trips is exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.solvers import tritd_admm_checkpointed as j_checkpointed  # noqa: E402
from tritd_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from tritd_tpu_torch.solvers import TriTDConfig, tritd_admm, tritd_admm_checkpointed  # noqa: E402
from tritd_tpu_torch.solvers.admm import init_factors  # noqa: E402
from tritd_tpu_torch.utils import checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (10, 11, 12)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0):
    """Low-TriTD-rank truth + 5% of +-4 spikes, as the reference's test."""
    rng = np.random.default_rng(seed)
    a, b, c = (rng.standard_normal(s) for s in ((10, 2, 2), (2, 11, 2), (2, 2, 12)))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = x / np.sqrt(np.mean(x**2))
    return x + (rng.random(SHAPE) < 0.05) * np.where(rng.random(SHAPE) < 0.5, 4.0, -4.0)


def _steps(path):
    return sorted(p for p in os.listdir(path) if p.startswith("step_"))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    d = _data()
    cfg = TriTDConfig(rank=2, max_iter=30, tol=0.0, dtype="float64")
    with jax.enable_x64(True):
        jd = jnp.asarray(d)
        j_checkpointed(jd, JConfig(rank=2, max_iter=15, tol=0.0, dtype="float64"),
                       str(tmp_path / "jax"), every=5)
        want = j_checkpointed(jd, JConfig(rank=2, max_iter=30, tol=0.0, dtype="float64"),
                              str(tmp_path / "jax_full"), every=5)
        want = {f: np.asarray(getattr(want, f)) for f in want._fields}
    assert _steps(tmp_path / "jax")[-1] == "step_000015.npz"
    got = tritd_admm_checkpointed(torch.from_numpy(d), cfg, str(tmp_path / "jax"), every=5)
    assert got.n_iters == 30 and got.err_hist.dtype == torch.float64
    np.testing.assert_allclose(got.err_hist.numpy(), want["err_hist"], rtol=1e-8)
    for f in ("a", "b", "c"):
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f], rtol=1e-6,
                                   atol=1e-8 * np.abs(want[f]).max(), err_msg=f)


def test_port_checkpoint_loads_and_resumes_in_jax(tmp_path):
    d = _data(1)
    cfg = TriTDConfig(rank=2, max_iter=10, tol=0.0, dtype="float64")
    tritd_admm_checkpointed(torch.from_numpy(d), cfg, str(tmp_path / "port"), every=5)
    path = str(tmp_path / "port" / "step_000010.npz")
    mine = checkpoint.load_state(path, device="cpu")
    with jax.enable_x64(True):
        theirs = jcheckpoint.load_state(path)
        assert set(theirs._fields) == set(mine._fields)
        assert type(mine.k) is int and mine.k == int(theirs.k) == 10
        for f in theirs._fields:
            if f == "k":
                continue
            w, g = np.asarray(getattr(theirs, f)), getattr(mine, f)
            g = np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g)
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        assert theirs.mu_l.dtype == jnp.float64
        resumed = j_checkpointed(jnp.asarray(d), JConfig(rank=2, max_iter=20, tol=0.0, dtype="float64"),
                                 str(tmp_path / "port"), every=5)
        resumed = np.asarray(resumed.err_hist)
    full = tritd_admm_checkpointed(torch.from_numpy(d), TriTDConfig(rank=2, max_iter=20, tol=0.0, dtype="float64"),
                                   str(tmp_path / "port_full"), every=5)
    np.testing.assert_allclose(resumed, full.err_hist.numpy(), rtol=1e-8)


@pytest.mark.parametrize("storage", [None, "bfloat16"], ids=["f32", "bf16_storage"])
def test_resume_is_bitwise(tmp_path, storage):
    d = torch.from_numpy(_data(2))
    cfg = TriTDConfig(rank=2, max_iter=30, tol=0.0, storage_dtype=storage)
    full = tritd_admm_checkpointed(d, cfg, str(tmp_path / "full"), every=10)
    short = TriTDConfig(rank=2, max_iter=15, tol=0.0, storage_dtype=storage)
    tritd_admm_checkpointed(d, short, str(tmp_path / "crash"), every=10)
    assert _steps(tmp_path / "crash") == ["step_000010.npz", "step_000015.npz"]
    resumed = tritd_admm_checkpointed(d, cfg, str(tmp_path / "crash"), every=10)
    assert resumed.n_iters == 30 and resumed.o.dtype == torch.float32
    for f in ("err_hist", "a", "b", "c", "o", "e"):
        torch.testing.assert_close(getattr(resumed, f), getattr(full, f), rtol=0, atol=0, equal_nan=True)
    # the segmented run is the monolithic solver's trajectory
    mono = tritd_admm(d, cfg)
    np.testing.assert_allclose(full.err_hist.numpy(), mono.err_hist.numpy(), rtol=1e-6)


def test_state_round_trips_exactly(tmp_path):
    cfg = TriTDConfig(rank=2, max_iter=7, tol=0.0, storage_dtype="bfloat16")
    d = torch.from_numpy(_data(3)).float()
    tritd_admm_checkpointed(d, cfg, str(tmp_path), every=7)
    path = str(tmp_path / "step_000007.npz")
    with np.load(path) as f:
        assert f["o"].dtype == np.float32 and f["k"].dtype == np.int32 and f["done"].dtype == np.bool_
        assert f["mu_l"].shape == () and f["mu_l"].dtype == np.float32
    state = checkpoint.load_state(path, torch.float32, einsum_dtype=None, storage_dtype=torch.bfloat16,
                                  device="cpu")
    assert state.o.dtype == state.t.dtype == torch.bfloat16 and state.a.dtype == torch.float32
    assert type(state.k) is int and state.k == 7
    assert isinstance(state.mu_l, np.float32) and state.done.shape == () and state.done.dtype == torch.bool
    again = str(tmp_path / "again.npz")
    checkpoint.save_state(again, state)
    with np.load(path) as f, np.load(again) as g:
        assert sorted(f.files) == sorted(g.files)
        for name in f.files:
            assert f[name].dtype == g[name].dtype, name
            np.testing.assert_array_equal(f[name], g[name], err_msg=name)


def test_checkpoint_without_t_is_backfilled(tmp_path):
    d = torch.from_numpy(_data(4))
    cfg = TriTDConfig(rank=2, max_iter=5, tol=0.0, dtype="float64")
    tritd_admm_checkpointed(d, cfg, str(tmp_path), every=5)
    with np.load(tmp_path / "step_000005.npz") as f:
        arrays = {k: f[k] for k in f.files if k != "t"}
    np.savez(tmp_path / "old.npz", **arrays)
    with pytest.raises(ValueError, match="'t'"):
        checkpoint.load_state(str(tmp_path / "old.npz"), device="cpu")
    state = checkpoint.load_state(str(tmp_path / "old.npz"), d=d)
    with np.load(tmp_path / "step_000005.npz") as f:
        np.testing.assert_allclose(state.t.numpy(), f["t"], rtol=1e-12, atol=1e-12)
    with pytest.raises(KeyError, match="missing fields"):
        np.savez(tmp_path / "bad.npz", **{k: v for k, v in arrays.items() if k != "mu_o"})
        checkpoint.load_state(str(tmp_path / "bad.npz"), d=d)


def test_checkpoint_manager(tmp_path):
    with pytest.raises(NotImplementedError, match="Orbax"):
        checkpoint.CheckpointManager(str(tmp_path), use_orbax=True)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), every=3)
    assert mgr.latest() is None
    d = torch.from_numpy(_data(5))
    cfg = TriTDConfig(rank=2, max_iter=7, tol=0.0)
    from tritd_tpu_torch.solvers import admm_iteration, init_state

    state = init_state(d, cfg, init_factors(torch.Generator().manual_seed(0), SHAPE, 2, torch.float32, device="cpu"))
    saved = []
    for _ in range(7):
        state = admm_iteration(d.float(), state, cfg)
        saved.append(mgr.maybe_save(state))
    assert [p is not None for p in saved] == [False, False, True, False, False, True, False]
    assert mgr.latest().endswith("step_000006.npz")


def test_kill_drill_then_resume(tmp_path):
    """A process that dies right after its step-10 checkpoint (exit 17), then
    a resume here: the same trajectory as a run that never died. The child
    imports only the port."""
    d = _data(6).astype(np.float32)
    np.save(tmp_path / "d.npy", d)
    ckpt = tmp_path / "ckpt"
    code = (
        "import sys, numpy as np, torch\n"
        "from tritd_tpu_torch.solvers import TriTDConfig, tritd_admm_checkpointed\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'tritd_tpu.')) for m in sys.modules)\n"
        f"d = torch.from_numpy(np.load({str(tmp_path / 'd.npy')!r}))\n"
        "tritd_admm_checkpointed(d, TriTDConfig(rank=2, max_iter=30, tol=0.0), "
        f"{str(ckpt)!r}, every=10)\n"
        "sys.exit(3)\n"
    )
    env = dict(os.environ, TRITD_DIE_AFTER_SAVE_STEP="10")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 17, proc.stderr
    assert _steps(ckpt) == ["step_000010.npz"]
    cfg = TriTDConfig(rank=2, max_iter=30, tol=0.0)
    resumed = tritd_admm_checkpointed(torch.from_numpy(d), cfg, str(ckpt), every=10)
    full = tritd_admm_checkpointed(torch.from_numpy(d), cfg, str(tmp_path / "full"), every=10)
    assert resumed.n_iters == 30
    torch.testing.assert_close(resumed.err_hist, full.err_hist, rtol=0, atol=0)
    torch.testing.assert_close(resumed.a, full.a, rtol=0, atol=0)
