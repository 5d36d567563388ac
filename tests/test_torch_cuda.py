"""PyTorch port on an NVIDIA GPU: the hand-written elementwise-block kernel
against its plain PyTorch version, and a short solve that must launch the
kernel once per iteration. Skipped with a reason where CUDA is absent.

This file imports no JAX, so it also runs on a machine without it; there,
skip the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: tensors rtol 1e-6 with atol 1e-6 * max|input| — nvcc contracts
`a*b + c` into one FMA and PyTorch's CUDA division by a host scalar
multiplies by its reciprocal, so single outputs differ by an ulp or two and
more where terms cancel; bf16 tensors one bf16 ulp (rtol 2**-8, atol
2**-8 * max|input|), since such an ulp in the compute dtype can flip a
rounding to bf16; norms rtol 1e-5 — the kernel sums in double, the plain
version in the dtype, in another order. The narrow variants also go
through `hopper_kernels.check_narrow_against_plain`: at most the
dtype's share NARROW_FLIP_SHARE of each narrow output rounded otherwise
than the plain version (or NARROW_FLIP_FLOOR elements; float16, denser in
ties, 8 times bf16's share), each within one rounding step of
its dtype (`NARROW_ULP`: 2**-8 bf16, 2**-11 float16, 2**-4 e4m3fn, 2**-3
e5m2), and T' bitwise the `narrow_cast` of D - O' + Y_L'/muL_next from the
kernel's own stored O' and Y_L'. At the edges of the narrow formats, where
the inputs make every step exact (`hopper_kernels.edge_args`), every store
equals the plain version's on the CPU bitwise, NaN where it has NaN.

The kernel cases run three ways at the same tolerances: on tensors as
PyTorch allocates them (16-byte accesses), on views one element past a
16-byte boundary (the kernel's one-element path), and from two streams at
once (each stream has its own partial sums and ticket counter).

The SVT routes and the baselines launch no kernel of this package (they run
on cuSOLVER through `ops/device_linalg.py` and torch.matmul); their cases
here hold the float32 CUDA run to a float64 CPU run of the same code: SVT outputs rtol 1e-4 of ||M||,
err_hist of 10 iterations rtol 1e-3 (float32 rounding carried through the
discontinuous `>1` gate). The Tensor Toolbox surface launches none either:
its cases hold float32 on the card to float64 on the CPU on the same numpy
inputs: MTTKRP (dense, and sparse with its atomic adds) within 1e-4 of the
largest entry, the `cp_als` and `tucker_hooi` fits after a fixed number of
sweeps within 1e-4, an `eig_sshopm` eigenvalue within 1e-4 with an
eigen-residual under 1e-3. The Toolbox classes (`ops/classes.py`) are held
the same way, and every result must lie on the card; `default_device(None)`
is the card. The emulator-parity harness runs its `--tiny` problem on the
card in float64: each row within 1e-10 of the emulator, `triple` with one
launch of the f64 T' kernel variant per iteration.

`tritd_admm` on the card runs each block of `unroll` iterations as one
replay of a CUDA graph; its results are held bitwise to the eager loop's
(`run_admm(..., _eager=True)`): the same kernels on the same values. So
are the other solve loops' graph routes: `tritd_admm_checkpointed`'s
segments (one loop for the call, at most two captures, max_iter + one
synchronizing call a segment, the saves apart), `tritd_admm_outlier` and
`tritd_als` (a read of the stop flag after each iteration short of
max_iter and one at the end), `tritd_mals` (one synchronizing call). The
solve methods "pinv" and "lstsq" take the eager loop on the card: their
torch forms cannot be captured (a subprocess shows the capture raising).
SOFIA's kernels (`ops/sofia_kernels.py`) against their plain versions:
the row pinv within 64 r eps times each gram's condition of its row's
scale (two backward-stable solves of one system), an all-zero gram's row
exactly zero; the mode-3 step (`mode3_sweep`, one launch) and the sweep
alone within 256 eps of their largest value (one chain of products and
sums in two orders; the systems well conditioned), a system the mode-3
step cannot factor NaN from its row on. SOFIA's loops on the graph route
bitwise their device programs without graphs, at r = 3 and r = 4.

The binding's eigh and SVD (`ops/device_linalg.py`) against torch.linalg on
the card: bitwise where it takes torch's driver, else within 64 n eps of the
matrix's norm (eigenvalues, singular values, reconstructions), an eigh up
to n = 512 and an SVD up to a thin side of SVD_JACOBI_MAX_K captured in a
CUDA graph and replayed bitwise. The hand-written Jacobi SVD
(`csrc/jacobi_svd.cu`) against its plain version on the same CUDA tensor
and against torch.linalg.svd of the matrix in float64: singular values
within 64 k eps s_max of the latter (each, and the two within twice that of
each other), the reconstruction within that times sqrt(k) (Frobenius), the
vectors orthonormal within the rotation test's tolerance sqrt(k) eps plus
64 k eps. The SVT baselines'
loops (`baselines/device_loop.py`), `trpca_snn` and `tucker_hooi` on the
graph route: the captures, the synchronizing calls inside the loop, bitwise
the device form without graphs; with an eigh or SVD past the captured
limit, the eager loop."""

import contextlib
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_toolbox_loop_cases as toolbox_cases  # noqa: E402
from tritd_tpu_torch.cli.run_completion import run_method  # noqa: E402
from tritd_tpu_torch.data.loaders import DatasetSpec, synthetic_traffic  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops import svt as svt_ops  # noqa: E402
from tritd_tpu_torch.ops.device_linalg import JACOBI_LIMITS, LAPACK_SWEEPS  # noqa: E402
from tritd_tpu_torch.ops.narrow import narrow_cast  # noqa: E402
from tritd_tpu_torch.runtime import native  # noqa: E402
from tritd_tpu_torch.solvers import (  # noqa: E402
    OutlierConfig,
    TriTDConfig,
    init_factors,
    init_state,
    run_admm,
    tritd_admm,
    tritd_admm_checkpointed,
    tritd_admm_outlier,
    tritd_als,
    tritd_mals,
)
from tritd_tpu_torch.utils import checkpoint  # noqa: E402
from tritd_tpu_torch.tools import sweep_block  # noqa: E402
from tritd_tpu_torch.utils.config import COMPLETION_TRITD, VIDEO_TRITD  # noqa: E402

SCALARS = (0.5, 0.7, 1.8)
MU_NEXT = 0.625


# an odd count above one resident wave of the widest groups (8 elements)
ODD_ABOVE_A_WAVE = 2 * hopper_kernels.RESIDENT_BLOCKS * hopper_kernels.BLOCK_THREADS * 8 + 13
HOW = ["aligned", "shifted", "two_streams"]


def _shifted(x):
    """The same values behind a pointer one element past a 16-byte boundary."""
    view = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(x.shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


def _run(how, fn):
    """The outputs of `fn()`: one call, or five turns of one call on each of
    two streams without a synchronize between them."""
    if how != "two_streams":
        return [fn()]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(5):
        for stream in streams:
            with torch.cuda.stream(stream):
                outs.append(fn())
    return outs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("how", HOW)
@pytest.mark.parametrize("with_t", [False, True], ids=["no_t", "t"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(17, 23, 31), (8, 128, 4), (1, 1, 1), (100, 100, 500),
                                   # the slabs a rank of a sharded solve holds: a quarter and a
                                   # padded third of taxi along mode 1, a quarter of video along mode 3
                                   (25, 100, 500), (34, 100, 500), (240, 320, 75),
                                   # around a group, a warp and a block, and past one wave
                                   (7,), (8,), (9,), (255,), (257,), (ODD_ABOVE_A_WAVE,)], ids=str)
def test_kernel_matches_plain(cuda_device, shape, dtype, with_t, how):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    args = [torch.randn(shape, generator=gen, dtype=dtype, device=cuda_device) for _ in range(5)]
    if how == "shifted":
        args = [_shifted(a) for a in args]
    mu_next = MU_NEXT if with_t else None
    key = f"elementwise_block[{hopper_kernels.kernel_variant(*args)}]"
    before = hopper_kernels.LAUNCHES[key]
    outs = _run(how, lambda: hopper_kernels.elementwise_block(*args, *SCALARS, mu_l_next=mu_next))
    torch.cuda.synchronize()
    assert hopper_kernels.LAUNCHES[key] == before + len(outs)
    want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next)
    atol = 1e-6 * max(float(a.abs().max()) for a in args)
    for got in outs:
        for i in (0, 1, 2, 3):
            assert got[i].dtype == dtype and got[i].shape == shape and got[i].is_contiguous()
            torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=atol)
        for i in (4, 5):
            assert got[i].shape == () and got[i].device.type == "cuda"
            torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
        if with_t:
            torch.testing.assert_close(got[6], want[6], rtol=1e-6, atol=atol)
        else:
            assert got[6] is None


@pytest.mark.cuda
def test_kernel_sums_are_deterministic(cuda_device):
    args = [torch.randn(240, 320, 30, device=cuda_device) for _ in range(5)]
    first = hopper_kernels.elementwise_block(*args, *SCALARS)
    for _ in range(20):
        again = hopper_kernels.elementwise_block(*args, *SCALARS)
        assert float(first[4]) == float(again[4]) and float(first[5]) == float(again[5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_shifted_inputs_give_the_same_elements(cuda_device, dtype):
    """Both paths of the kernel do the same arithmetic per element; only the
    partition of the two sums differs, so those agree to rounding in double
    (rtol 1e-12 at float64, 1e-6 where the sums come back in float32)."""
    args = [torch.randn(ODD_ABOVE_A_WAVE, dtype=dtype, device=cuda_device) for _ in range(5)]
    got = hopper_kernels.elementwise_block(*args, *SCALARS, mu_l_next=MU_NEXT)
    off = hopper_kernels.elementwise_block(*map(_shifted, args), *SCALARS, mu_l_next=MU_NEXT)
    for i in (0, 1, 2, 3, 6):
        assert torch.equal(got[i], off[i])
    for i in (4, 5):
        torch.testing.assert_close(got[i], off[i], rtol=1e-12 if dtype == torch.float64 else 1e-6, atol=0.0)


@pytest.mark.cuda
def test_solve_launches_the_kernel_every_iteration(cuda_device):
    """Small solve on the card: one kernel launch per iteration, and the
    err_hist of the float32 CUDA run within rtol 1e-3 of a float64 CPU run
    from the same init (f32 rounding over 15 iterations)."""
    rng = np.random.default_rng(0)
    shape = (20, 16, 24)
    y = torch.from_numpy(rng.standard_normal(shape) * 10)
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=15, tol=0.0)
    init = init_factors(torch.Generator().manual_seed(0), shape, cfg.rank, torch.float32)
    hopper_kernels.reset_launch_counts()
    gpu = tritd_admm(y.float().to(cuda_device), cfg, init=init)
    assert hopper_kernels.LAUNCHES["elementwise_block[f32]"] == gpu.n_iters == 15
    cpu = tritd_admm(y, dataclasses.replace(cfg, dtype="float64"), init=init)
    np.testing.assert_allclose(gpu.err_hist.cpu().numpy(), cpu.err_hist.numpy(), rtol=1e-3)


def _route_solves(cfg, y, mask=None):
    """run_admm from one state as tritd_admm sets it up, on the graph route
    and on the eager loop, with the launches each counts."""
    init = init_factors(torch.Generator().manual_seed(0), tuple(y.shape), cfg.rank, cfg.torch_dtype())
    d = y.to(cfg.torch_dtype())
    out = []
    for eager in (False, True):
        hopper_kernels.reset_launch_counts()
        state = init_state(d, cfg, init)
        res = run_admm(narrow_cast(d, cfg.torch_storage_dtype()), state, cfg, mask=mask, origin=d,
                       norm_d=torch.linalg.vector_norm(d), _eager=eager)
        torch.cuda.synchronize()
        out.append((res, {k: v for k, v in hopper_kernels.LAUNCHES.items() if v},
                    {k: v for k, v in hopper_kernels.POINTER_LAUNCHES.items() if v}))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [dict(), dict(unroll=3), dict(masked=True), dict(storage_dtype="bfloat16"),
                                    dict(dtype="float64", unroll=2), dict(tol=1e-2, unroll=2)], ids=str)
def test_graph_route_is_the_eager_loop_bitwise(cuda_device, fields):
    """At a small shape: every field of the final state and the penalties in
    the same bits on both routes, and the kernel's launches, counted by
    replays of the graph on its route, one per iteration on both."""
    rng = np.random.default_rng(2)
    shape = (20, 16, 24)
    x = torch.from_numpy(rng.standard_normal(shape) * 10).to(cuda_device)
    mask = torch.from_numpy(rng.random(shape) >= 0.1).to(cuda_device)
    cfg = dataclasses.replace(COMPLETION_TRITD, **{"max_iter": 25, "tol": 0.0, **fields})
    (graph, g_launches, _), (eager, e_launches, _) = _route_solves(cfg, torch.where(mask, x, 0.0),
                                                                   mask if cfg.masked else None)
    assert graph.k == eager.k and graph.mu_l.tobytes() == eager.mu_l.tobytes()
    assert g_launches == e_launches and sum(g_launches.values()) == graph.k
    if cfg.tol:
        assert graph.k < cfg.max_iter
    for f in ("a", "b", "c", "o", "e", "y_l", "y_o", "t", "err_hist", "rre_hist", "done"):
        got, want = getattr(graph, f), getattr(eager, f)
        assert got.dtype == want.dtype and torch.equal(got.reshape(-1).view(torch.uint8),
                                                       want.reshape(-1).view(torch.uint8)), f


@pytest.mark.cuda
def test_graph_route_launches_through_the_pointer_entry(cuda_device):
    """Every launch of the graph route, its eager first block's too, goes
    through the pointer entry; none of the eager loop's does."""
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.standard_normal((20, 16, 24)) * 10).float().to(cuda_device)
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=7, tol=0.0, unroll=2)
    (graph, g_launches, g_pointer), (_eager, e_launches, e_pointer) = _route_solves(cfg, y)
    assert g_launches == e_launches == {"elementwise_block[f32]": 8} and graph.k == 8
    assert g_pointer == {"elementwise_block_ptr[f32]": 8} and e_pointer == {}


@pytest.mark.cuda
def test_capture_that_meets_a_host_sync_raises(cuda_device, monkeypatch):
    """A read back to the host inside the captured block fails the capture,
    which raises (no quiet fallback to the eager loop); the card is usable
    after it."""
    from tritd_tpu_torch.solvers import admm

    real = admm.update_factors

    def syncing(t, a, b, c, cfg, **kw):
        float(a.sum())
        return real(t, a, b, c, cfg, **kw)

    y = torch.from_numpy(np.random.default_rng(3).standard_normal((20, 16, 24)) * 10).float().to(cuda_device)
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=4, tol=0.0)
    monkeypatch.setattr(admm, "update_factors", syncing)
    with pytest.raises(RuntimeError, match="capturing"):
        tritd_admm(y, cfg)
    monkeypatch.setattr(admm, "update_factors", real)
    assert tritd_admm(y, cfg).n_iters == 4


@pytest.mark.cuda
def test_launches_count_the_graph_replays(cuda_device):
    """The capture counts nothing; each replay counts its kernel nodes: a
    solve of 4 blocks of 3 iterations counts 12 launches, 3 of them the
    first block's, run eagerly."""
    y = torch.from_numpy(np.random.default_rng(4).standard_normal((20, 16, 24)) * 10).float().to(cuda_device)
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=12, tol=0.0, unroll=3)
    hopper_kernels.reset_launch_counts()
    res = tritd_admm(y, cfg)
    torch.cuda.synchronize()
    assert res.n_iters == 12 and hopper_kernels.LAUNCHES["elementwise_block[f32]"] == 12
    hopper_kernels.reset_launch_counts()
    tritd_admm(y, dataclasses.replace(cfg, max_iter=3))
    assert hopper_kernels.LAUNCHES["elementwise_block[f32]"] == 3


@pytest.mark.cuda
def test_numpy_input_solves_on_the_card(cuda_device, tmp_path):
    """A numpy array given to a solver goes to the card (as the reference
    places it on its accelerator): the solve launches the kernel every
    iteration and returns CUDA tensors; load_state loads onto the card."""
    d = np.random.default_rng(0).standard_normal((20, 16, 24)) * 10
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=5, tol=0.0)
    hopper_kernels.reset_launch_counts()
    res = tritd_admm(d, cfg)
    assert res.a.is_cuda and res.o.is_cuda and res.err_hist.is_cuda
    assert hopper_kernels.LAUNCHES["elementwise_block[f32]"] == res.n_iters == 5
    for solve in (lambda: tritd_admm_checkpointed(d, cfg, str(tmp_path), every=5),
                  lambda: tritd_admm_outlier(d, OutlierConfig(rank=5, max_iter=2)),
                  lambda: tritd_als(d, TriTDConfig(rank=5, max_iter=2)),
                  lambda: tritd_mals(d, TriTDConfig(rank=5, max_iter=2))):
        assert solve().a.is_cuda
    assert checkpoint.load_state(str(tmp_path / "step_000005.npz")).o.is_cuda


@contextlib.contextmanager
def _one_nccl_rank():
    """This process as a one-rank NCCL group on the card; yields its mesh."""
    import socket

    import torch.distributed as dist

    from tritd_tpu_torch.parallel import make_mesh
    from tritd_tpu_torch.parallel.distributed import initialize_distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_distributed(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, backend="nccl", device="cuda:0",
                           timeout_s=120.0)
    try:
        yield make_mesh(device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_solve_on_one_nccl_rank_matches_tritd_admm(cuda_device):
    """The parallel layer with one rank on NCCL: the slab (padded by
    nothing) lives on the card, the kernel runs once per iteration, and the
    histories are tritd_admm's within rtol 1e-6 (one rank reduces nothing;
    the norms are roots of reduced sums of squares, there vector norms)."""
    import torch.distributed as dist

    from tritd_tpu_torch.parallel import tritd_admm_auto, tritd_admm_sharded

    rng = np.random.default_rng(1)
    shape = (22, 16, 27)
    y = rng.standard_normal(shape).astype(np.float32) * 10
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=15, tol=0.0)
    init = init_factors(torch.Generator().manual_seed(0), shape, cfg.rank, torch.float32)
    with _one_nccl_rank() as mesh:
        want = tritd_admm(torch.from_numpy(y).to(cuda_device), cfg, origin=torch.from_numpy(y).to(cuda_device), init=init)
        for mode in (1, 3):
            hopper_kernels.reset_launch_counts()
            audit = {}
            got = tritd_admm_sharded(y, cfg, mesh, shard_tensor_mode=mode, origin=y, init=init, audit=audit)
            assert hopper_kernels.LAUNCHES["elementwise_block[f32]"] == got.n_iters == 15
            assert got.o.device.type == "cuda" and audit["per_iter"]["calls"] == 4
            torch.testing.assert_close(got.err_hist, want.err_hist, rtol=1e-6, atol=0)
            torch.testing.assert_close(got.rre_hist, want.rre_hist, rtol=1e-6, atol=0)
        # the bare NCCL group puts even a CPU tensor's slab on the card, and
        # tritd_admm_auto is the mode-1 solve bit for bit
        bare = tritd_admm_sharded(torch.from_numpy(y), cfg, dist.group.WORLD, origin=y, init=init)
        auto = tritd_admm_auto(y, cfg, mesh, axis_name="slab", origin=y, init=init)
        assert bare.o.device.type == auto.o.device.type == "cuda"
        for f in ("a", "o", "e", "err_hist", "rre_hist"):
            assert torch.equal(getattr(auto, f), getattr(bare, f)), f


@pytest.mark.cuda
def test_numpy_input_to_the_baselines_goes_to_the_card(cuda_device, monkeypatch):
    """Each baseline entry point and the sharded solve over a bare gloo group
    put numpy input on the card, as the reference places it on its
    accelerator: every output tensor is a CUDA tensor; the freedom ratio
    computed from numpy serves a later solve of the same data on the card;
    SOFIA's stream steps run on the card."""
    import importlib

    import torch.distributed as dist
    from torch_baseline_entries import ENTRIES, MASK, Y, devices

    rtrc_mod = importlib.import_module("tritd_tpu_torch.baselines.rtrc")
    sofia_mod = importlib.import_module("tritd_tpu_torch.baselines.sofia")
    scan, seen = sofia_mod._stream_scan, []
    monkeypatch.setattr(sofia_mod, "_stream_scan", lambda *a: seen.append(a[0].device.type) or scan(*a))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        for name, entry in ENTRIES.items():
            out = entry(lambda a: a)
            if name not in ("precompute_freedom_ratio", "sofia_stream_device"):
                assert devices(out) == {"cuda"}, name
    finally:
        dist.destroy_process_group()
    assert seen == ["cuda"]
    first = rtrc_mod.precompute_freedom_ratio(Y, MASK)
    p = torch.as_tensor(MASK, device=cuda_device).to(torch.float64)
    assert rtrc_mod.freedom_ratio(torch.as_tensor(Y, device=cuda_device) * p, p) is first


# (D, storage, T', with T') of the narrow variants, by the solver path
# that produces them
NARROW = {
    "storage": (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
    "masked_storage": (None, torch.bfloat16, torch.bfloat16, False),
    "einsum_only": (None, None, torch.bfloat16, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("how", HOW)
@pytest.mark.parametrize("case", list(NARROW))
@pytest.mark.parametrize("compute", [torch.float32, torch.float64], ids=["c32", "c64"])
@pytest.mark.parametrize("shape", [(17, 23, 31), (1, 1, 1), (100, 100, 500), (7,), (9,), (257,),
                                   (ODD_ABOVE_A_WAVE,)], ids=str)
def test_narrow_kernel_matches_plain(cuda_device, shape, compute, case, how):
    d_dt, s_dt, t_dt, with_t = NARROW[case]
    d_dt, s_dt = d_dt or compute, s_dt or compute
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    raw = [torch.randn(shape, generator=gen, dtype=compute, device=cuda_device) * 3 for _ in range(5)]
    args = [raw[0].to(d_dt), raw[1], *(x.to(s_dt) for x in raw[2:])]
    if how == "shifted":
        args = [_shifted(a) for a in args]  # bf16 views start 2 bytes past a 16-byte boundary
    variant = hopper_kernels.kernel_variant(*args, t_dtype=t_dt)
    mu_next = MU_NEXT if with_t else None
    before = hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"]
    outs = _run(how, lambda: hopper_kernels.elementwise_block(*args, *SCALARS, mu_l_next=mu_next, t_dtype=t_dt))
    torch.cuda.synchronize()
    assert hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"] == before + len(outs)
    want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next, compute_dtype=compute,
                                       store_dtype=s_dt, t_dtype=t_dt)
    for got in outs:
        for i in (0, 1, 2, 3):
            assert got[i].dtype == s_dt and got[i].shape == shape and got[i].is_contiguous()
        hopper_kernels.check_narrow_against_plain(args, got, want, mu_next)
        for i in (4, 5):
            assert got[i].dtype == compute
            torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
        if with_t:
            assert got[6].dtype == t_dt
        else:
            assert got[6] is None


@pytest.mark.cuda
@pytest.mark.parametrize("fields, masked, variant", [
    (dict(storage_dtype="bfloat16"), False, "c32_dbf16_sbf16_tbf16"),
    (dict(storage_dtype="bfloat16"), True, "c32_d32_sbf16_tbf16"),
    (dict(einsum_dtype="bfloat16"), False, "c32_d32_s32_tbf16"),
], ids=["storage", "storage_masked", "einsum"])
def test_narrow_solve_launches_its_variant(cuda_device, fields, masked, variant):
    """A narrow solve on the card launches its kernel variant once per
    iteration, and lands within 0.03 RRE of the float32 run."""
    rng = np.random.default_rng(2)
    shape = (20, 16, 24)
    a, b, c = (rng.standard_normal(s) for s in ((20, 2, 2), (2, 16, 2), (2, 2, 24)))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = torch.from_numpy(x / np.sqrt(np.mean(x**2))).float().to(cuda_device)
    mask = torch.from_numpy(rng.random(shape) > 0.2).to(cuda_device) if masked else None
    y = torch.where(mask, x, torch.zeros_like(x)) if masked else x
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=2, max_iter=40, tol=0.0, masked=masked)
    init = init_factors(torch.Generator().manual_seed(0), shape, 2, torch.float32)
    hopper_kernels.reset_launch_counts()
    narrow = tritd_admm(y, dataclasses.replace(cfg, **fields), mask=mask, origin=x, init=init)
    assert hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"] == narrow.n_iters == 40
    assert narrow.o.dtype == torch.float32 and torch.isfinite(narrow.err_hist).all()
    wide = tritd_admm(y, cfg, mask=mask, origin=x, init=init)
    assert abs(float(narrow.rre_hist[-1]) - float(wide.rre_hist[-1])) < 0.03


# the variants with a float16 or float8 stream: per dtype X storage X,
# masked storage X and einsum X alone, and storage and einsum in two
# different narrow dtypes
NEW_DTYPES = (torch.float16, torch.float8_e4m3fn, torch.float8_e5m2)
NEW_VARIANTS = {v: k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if set(k) & set(NEW_DTYPES)}
def _new_variant(variant):
    """(compute, D, storage, T') of a variant, T' None where it carries none
    (masked storage)."""
    compute, d_dt, s_dt, t_dt = NEW_VARIANTS[variant]
    return compute, d_dt, s_dt, None if (d_dt == compute and s_dt != compute) else t_dt


@pytest.mark.cuda
@pytest.mark.parametrize("how", HOW)
@pytest.mark.parametrize("variant", sorted(NEW_VARIANTS))
@pytest.mark.parametrize("shape", [(17, 23, 31), (257,), (ODD_ABOVE_A_WAVE,)], ids=str)
def test_narrow_dtype_kernel_matches_plain(cuda_device, shape, variant, how):
    compute, d_dt, s_dt, t_dt = _new_variant(variant)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    raw = [torch.randn(shape, generator=gen, dtype=compute, device=cuda_device) * 3 for _ in range(5)]
    args = [narrow_cast(raw[0], d_dt), raw[1], *(narrow_cast(x, s_dt) for x in raw[2:])]
    if how == "shifted":
        args = [_shifted(a) for a in args]  # float8 views start 1 byte past a 16-byte boundary
    assert hopper_kernels.kernel_variant(*args, t_dtype=t_dt or s_dt) == variant
    mu_next = None if t_dt is None else MU_NEXT
    before = hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"]
    outs = _run(how, lambda: hopper_kernels.elementwise_block(*args, *SCALARS, mu_l_next=mu_next, t_dtype=t_dt))
    torch.cuda.synchronize()
    assert hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"] == before + len(outs)
    want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next, compute_dtype=compute,
                                       store_dtype=s_dt, t_dtype=t_dt)
    for got in outs:
        for i in (0, 1, 2, 3):
            assert got[i].dtype == s_dt and got[i].shape == shape and got[i].is_contiguous()
        hopper_kernels.check_narrow_against_plain(args, got, want, mu_next)
        for i in (4, 5):
            torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
        assert (got[6] is None) == (t_dt is None) and (t_dt is None or got[6].dtype == t_dt)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(v for k, v in hopper_kernels.KERNEL_VARIANTS.items()
                                           if set(k) - {torch.float32, torch.float64}))
def test_kernel_stores_round_as_narrow_cast_at_the_edges(cuda_device, variant):
    """Every narrow store of the kernel equals the plain version's on the
    CPU (narrow_cast, the reference's rounding) bitwise, NaN where it has
    NaN: e4m3fn past 464 and +-inf, e5m2 from 61440, the subnormals and the
    float64 values one rounding and two round apart."""
    key = next(k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    compute, d_dt, s_dt, t_dt = key
    masked = d_dt == compute and s_dt != compute
    edges = hopper_kernels.EDGE_VALUES
    values = edges * 3 + edges[:5]  # whole groups and a one-element tail
    args = hopper_kernels.edge_args(values, key, cuda_device)
    mu_next = None if masked else hopper_kernels.EDGE_MU_NEXT
    got = hopper_kernels.elementwise_block(*args, *hopper_kernels.EDGE_SCALARS, mu_l_next=mu_next, t_dtype=t_dt)
    want = hopper_kernels._block_torch(*(a.cpu() for a in args), *hopper_kernels.EDGE_SCALARS, mu_l_next=mu_next,
                                       compute_dtype=compute, store_dtype=s_dt, t_dtype=t_dt)
    assert hopper_kernels.check_stores_bitwise(got, want) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fields, masked, variant", [
    (dict(storage_dtype="float16"), False, "c32_df16_sf16_tf16"),
    (dict(storage_dtype="float16"), True, "c32_d32_sf16_tf16"),
    (dict(einsum_dtype="float16"), False, "c32_d32_s32_tf16"),
    (dict(storage_dtype="float8_e4m3fn"), False, "c32_de4m3_se4m3_te4m3"),
    (dict(storage_dtype="float8_e5m2"), True, "c32_d32_se5m2_te5m2"),
    (dict(einsum_dtype="float8_e5m2"), False, "c32_d32_s32_te5m2"),
    (dict(storage_dtype="float16", einsum_dtype="bfloat16"), False, "c32_df16_sf16_tbf16"),
    (dict(storage_dtype="bfloat16", einsum_dtype="float8_e4m3fn"), False, "c32_dbf16_sbf16_te4m3"),
    (dict(storage_dtype="float8_e5m2", dtype="float64"), False, "c64_de5m2_se5m2_te5m2"),
    (dict(storage_dtype="float64"), False, "c32_d64_s64_t64"),
    (dict(storage_dtype="float64"), True, "c32_d32_s64_t64"),
    (dict(storage_dtype="float32", dtype="float64"), False, "c64_d32_s32_t32"),
    (dict(storage_dtype="bfloat16", einsum_dtype="float32"), False, "c32_dbf16_sbf16_t32"),
], ids=["f16", "f16_masked", "einsum_f16", "e4m3", "e5m2_masked", "einsum_e5m2", "f16+bf16", "bf16+e4m3",
        "e5m2_f64", "f64", "f64_masked", "f32_at_f64", "bf16+f32"])
def test_narrow_dtype_solve_launches_its_variant(cuda_device, fields, masked, variant):
    """A solve in a new narrow dtype on the card launches its kernel variant
    once per iteration; err_hist stays finite, and the float16 ones land
    within 0.03 RRE of the float32 run (float8 has no such bound in the
    reference)."""
    rng = np.random.default_rng(2)
    shape = (20, 16, 24)
    a, b, c = (rng.standard_normal(s) for s in ((20, 2, 2), (2, 16, 2), (2, 2, 24)))
    x = np.einsum("iqs,qjs,qst->ijt", a, b, c)
    x = torch.from_numpy(x / np.sqrt(np.mean(x**2))).float().to(cuda_device)
    mask = torch.from_numpy(rng.random(shape) > 0.2).to(cuda_device) if masked else None
    y = torch.where(mask, x, torch.zeros_like(x)) if masked else x
    cfg = dataclasses.replace(COMPLETION_TRITD, rank=2, max_iter=40, tol=0.0, masked=masked)
    init = init_factors(torch.Generator().manual_seed(0), shape, 2, torch.float32)
    hopper_kernels.reset_launch_counts()
    narrow = tritd_admm(y, dataclasses.replace(cfg, **fields), mask=mask, origin=x, init=init)
    assert hopper_kernels.LAUNCHES[f"elementwise_block[{variant}]"] == narrow.n_iters == 40
    assert torch.isfinite(narrow.err_hist).all()
    if "float8" not in str(fields):
        wide = tritd_admm(y, cfg, mask=mask, origin=x, init=init)
        assert abs(float(narrow.rre_hist[-1]) - float(wide.rre_hist[-1])) < 0.03


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes, compute, store, variant", [
    ((torch.float32,) * 5, None, None, "f32"),
    ((torch.bfloat16, torch.float32, *(torch.bfloat16,) * 3), torch.float32, torch.bfloat16,
     "c32_dbf16_sbf16_tbf16"),
    ((torch.float64, torch.float32, *(torch.float64,) * 3), torch.float32, torch.float64, "c32_d64_s64_t64"),
    ((torch.bfloat16, torch.float32, torch.bfloat16, torch.float32, torch.float32), torch.float32, torch.float16,
     "f32"),
], ids=["f32", "bf16_storage", "f64_storage", "cast_route"])
def test_flat_block_launches_once_and_matches_the_cpu(cuda_device, dtypes, compute, store, variant):
    """`ops.elementwise_block` (the reference's signature) launches one
    kernel: the variant its dtypes name, or the pure one with the inputs
    cast and the stores rounded; the stores equal the plain version's on
    the CPU within one step of their dtype."""
    from tritd_tpu_torch import ops

    rng = np.random.default_rng(4)
    args = [narrow_cast(torch.from_numpy(rng.standard_normal((17, 23, 31)) * 3), dt).to(cuda_device)
            for dt in dtypes]
    hopper_kernels.reset_launch_counts()
    got = ops.elementwise_block(*args, *SCALARS, compute_dtype=compute, store_dtype=store)
    torch.cuda.synchronize()
    assert {k: v for k, v in hopper_kernels.LAUNCHES.items() if v} == {f"elementwise_block[{variant}]": 1}
    want = ops.elementwise_block(*(a.cpu() for a in args), *SCALARS, compute_dtype=compute, store_dtype=store)
    c = compute or torch.float32
    agree = hopper_kernels.check_narrow_against_plain([a.cpu().to(c) for a in args], (*(g.cpu() for g in got), None),
                                                      (*want, None))
    assert agree["max_abs_err"] < 1.0
    for i in (4, 5):
        torch.testing.assert_close(got[i].cpu(), want[i], rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_numpy_input_to_the_ops_and_metrics_goes_to_the_card(cuda_device):
    """Every entry of tests/torch_numpy_entries.py from numpy puts its
    results on the card (sofia_stream's are numpy by design)."""
    from torch_numpy_entries import ENTRIES

    for name, entry in ENTRIES.items():
        out = entry(lambda a: a)
        if name != "baselines.sofia_stream":
            leaves = [out] if isinstance(out, torch.Tensor) else list(_leaf_tensors(out))
            assert leaves and all(t.device.type == "cuda" for t in leaves), name


def _leaf_tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaf_tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaf_tensors(v)


def _spectrum_matrix(p, q, spectrum, seed=0):
    rng = np.random.default_rng(seed)
    k = min(p, q)
    u = np.linalg.qr(rng.standard_normal((p, k)))[0]
    v = np.linalg.qr(rng.standard_normal((q, k)))[0]
    s = np.zeros(k)
    s[: len(spectrum)] = spectrum
    return torch.from_numpy((u * s) @ v.T)


FLOAT8_VARIANTS = sorted(v for k, v in hopper_kernels.KERNEL_VARIANTS.items() if set(k) & set(hopper_kernels.FLOAT8))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", FLOAT8_VARIANTS)
def test_every_float8_code_is_stored_as_the_plain_version_stores_it(cuda_device, variant):
    """All 256 codes of each float8 dtype of the variant as D, E, Y_L and
    Y_O (`hopper_kernels.float8_code_args`) under EDGE_SCALARS: every store
    bitwise the plain version's on the CPU, NaN where it has NaN. The
    kernel widens float8 a pair at a time and packs it with the hardware's
    saturating conversion, restoring JAX's NaN and infinities per group."""
    key = next(k for k, v in hopper_kernels.KERNEL_VARIANTS.items() if v == variant)
    compute, d_dt, s_dt, t_dt = key
    mu_next = None if (d_dt == compute and s_dt != compute) else hopper_kernels.EDGE_MU_NEXT
    for fmt in sorted(set(key) & set(hopper_kernels.FLOAT8), key=str):
        args = hopper_kernels.float8_code_args(fmt, key, cuda_device)
        got = hopper_kernels.elementwise_block(*args, *hopper_kernels.EDGE_SCALARS, mu_l_next=mu_next, t_dtype=t_dt)
        want = hopper_kernels._block_torch(*(a.cpu() for a in args), *hopper_kernels.EDGE_SCALARS,
                                           mu_l_next=mu_next, compute_dtype=compute, store_dtype=s_dt, t_dtype=t_dt)
        assert hopper_kernels.check_stores_bitwise(got, want) >= 4 * args[0].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_division_is_bitwise_div_rn(cuda_device, dtype):
    """The kernel's division by a launch's mu (a reciprocal made once, one
    correction per element) against '/' bit for bit, for the presets'
    divisors and all-ones significands; divisors outside its range (and a
    negative one) take '/' for every numerator. `chip_smoke.py` phase 2
    takes every float32 numerator; here 2**26 bit patterns from 2**-8 up
    (float32) and 2**22 drawn numerators (float64)."""
    outside = [2.0**40, 2.0**-40, -3.0, 0.0]
    divisors = sweep_block.quotient_divisors(dtype, (COMPLETION_TRITD, VIDEO_TRITD)) + outside
    if dtype == torch.float32:
        counts = sweep_block.quotient_check(dtype, divisors, 2**26, first=0x3B800000)
    else:
        counts = sweep_block.quotient_check(dtype, divisors, 2**22)
    assert not counts[:, 0].any(), {divisors[k]: int(n) for k, n in enumerate(counts[:, 0]) if n}
    assert counts[: -len(outside), 1].min() > 0 and not counts[-len(outside):, 1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 2000), (2000, 64), (300, 300)], ids=str)
def test_svt_routes_on_the_card(cuda_device, shape):
    """gram, the randomized route (20 survivors in a budget of 32) and a
    warm refresh against the float64 SVD route on the CPU; the spectrum
    stays away from tau and tau + 1."""
    m64 = _spectrum_matrix(*shape, np.concatenate([np.linspace(60.0, 12.0, 20), np.linspace(1.5, 0.1, 20)]))
    want = svt_ops.svt_ref_compat(m64, 2.0, "svd")
    m = m64.float().to(cuda_device)
    atol = 1e-4 * float(torch.linalg.vector_norm(m64))
    eye = torch.eye(min(shape), device=cuda_device)
    outs = {
        "svd": svt_ops.svt_ref_compat(m, 2.0, "svd"),
        "gram": svt_ops.svt_ref_compat(m, 2.0, "gram"),
        "lowrank:32": svt_ops.svt_ref_compat(m, 2.0, "lowrank:32"),
        "warm refresh": svt_ops.svt_ref_compat_warm(m, 2.0, eye, True)[0],
        "plain gram": None,
    }
    for name, got in outs.items():
        if got is None:
            got, ref = svt_ops.svt(m, 2.0, "gram"), svt_ops.svt(m64, 2.0, "svd")
        else:
            ref = want
        assert got.device.type == "cuda" and got.dtype == torch.float32, name
        torch.testing.assert_close(got.cpu().double(), ref, rtol=0, atol=atol, msg=lambda s: f"{name}: {s}")
    assert torch.equal(outs["lowrank:32"], svt_ops.svt_ref_compat(m, 2.0, "lowrank:32"))  # a fixed sketch


@pytest.mark.cuda
@pytest.mark.parametrize("svt_method", ["svd", "gram", "warm:4"])
@pytest.mark.parametrize("method", ["ttnn", "ring", "fctn"])
def test_svt_baselines_on_the_card(cuda_device, method, svt_method):
    spec = DatasetSpec("tiny", "traffic", "T", (24, 20, 32), fctn_subdim=4, sofia_period=4)
    x = torch.from_numpy(synthetic_traffic(spec, np.random.default_rng(1)))
    mask = torch.from_numpy(np.random.default_rng(2).random(spec.shape) > 0.1)
    y = torch.where(mask, x, torch.zeros_like(x))
    gen = torch.Generator().manual_seed(0)
    _xh, _o, want = run_method(method, y, x, mask, spec, gen, 10, svt_method=svt_method)
    xh, o, got = run_method(method, y.float().to(cuda_device), x.float().to(cuda_device),
                            mask.to(cuda_device), spec, gen, 10, svt_method=svt_method)
    assert xh.device.type == o.device.type == "cuda" and xh.dtype == torch.float32
    assert got.shape == (10,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.cuda
def test_sofia_and_the_other_baselines_on_the_card(cuda_device):
    from tritd_tpu_torch.baselines import rnc_fctn, sofia_init, trpca_snn, trpca_tnn

    spec = DatasetSpec("tiny", "traffic", "T", (16, 14, 28), fctn_subdim=4, sofia_period=7)
    x = torch.from_numpy(synthetic_traffic(spec, np.random.default_rng(3)))
    xc = x.float().to(cuda_device)
    ones = torch.ones(spec.shape, dtype=torch.bool)
    init = tuple(torch.rand((n, 3), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
                 for n in spec.shape)
    _u, want_x, _o, want = sofia_init(x, ones, 3, 7, origin=x, max_epoch=4, u_init=init, dtype=torch.float64)
    u, xh, o, got = sofia_init(xc, ones.to(cuda_device), 3, 7, origin=xc, max_epoch=4, u_init=init)
    assert xh.device.type == o.device.type == u[2].device.type == "cuda"
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for fn, kw in ((trpca_tnn, dict(origin=xc, mu=1e-3)), (trpca_snn, dict(mu=1e-3))):
        low, sparse, hist = fn(xc, max_iter=8, **kw)
        ref = fn(x, max_iter=8, **{k: (x if k == "origin" else v) for k, v in kw.items()})[2]
        assert low.device.type == sparse.device.type == "cuda"
        np.testing.assert_allclose(hist.cpu().numpy(), ref.numpy(), rtol=1e-3)
    f4 = torch.rand((8, 7, 6, 5), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    om = torch.rand((8, 7, 6, 5), generator=torch.Generator().manual_seed(3)) > 0.2
    # one seed draws other numbers in float32 than in float64: hand both runs the same factors
    cores = [torch.rand(shape, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
             for shape in ((8, 2, 2, 2), (2, 7, 2, 2), (2, 2, 6, 2), (2, 2, 2, 5))]
    draws = dict(init=cores, pad_values=[0.25, 0.5, 0.75, 0.35, 0.65, 0.45])
    ref = rnc_fctn(f4, 0.1, om, origin=f4, max_iter=12, **draws)
    out = rnc_fctn(f4.float().to(cuda_device), 0.1, om.to(cuda_device), origin=f4.float().to(cuda_device),
                   max_iter=12, **draws)
    assert out[0].device.type == "cuda" and out[4] == ref[4]
    np.testing.assert_allclose(out[3], ref[3], rtol=1e-3)


@pytest.mark.cuda
def test_host_proximal_library_builds_beside_the_kernels(cuda_device):
    assert native.available()
    np.testing.assert_allclose(native.soft_threshold(np.array([-3.0, 0.5, 2.0]), 1.0), [-2.0, 0.0, 1.0])


# --- the Tensor Toolbox surface: float32 on the card against float64 on the CPU


def _toolbox_problem(shape=(40, 30, 50), rank=4, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    factors = [rng.standard_normal((s, rank)) for s in shape]
    clean = np.einsum("ir,jr,kr->ijk", *factors)
    nz = rng.standard_normal(shape)
    data = clean + noise * np.linalg.norm(clean) / np.linalg.norm(nz) * nz
    init = [rng.random((s, rank)) for s in shape]
    return data, factors, init


def _both(fn, *arrays):
    """fn on float32 CUDA tensors and on float64 CPU tensors of the same
    numpy inputs."""
    def conv(a, device, dtype):
        if isinstance(a, (list, tuple)):
            return [conv(u, device, dtype) for u in a]
        ten = torch.from_numpy(np.array(a))
        return ten.to(device) if ten.dtype == torch.int64 else ten.to(device=device, dtype=dtype)

    got = fn(*(conv(a, "cuda", torch.float32) for a in arrays))
    want = fn(*(conv(a, "cpu", torch.float64) for a in arrays))
    return got, want


@pytest.mark.cuda
def test_toolbox_mttkrp_on_the_card(cuda_device):
    """Dense and sparse MTTKRP, f32 on the card against f64 on the CPU:
    rtol 1e-4 of the largest entry (f32 sums of 1500-2000 terms; the sparse
    one adds atomically, in any order)."""
    from tritd_tpu_torch.ops import mttkrp, sp_full, sp_mttkrp

    data, factors, _ = _toolbox_problem()
    rng = np.random.default_rng(1)
    keep = rng.random(data.shape) < 0.3
    coords, vals = np.argwhere(keep), data[keep]
    for mode in range(3):
        got, want = _both(lambda x, fs: mttkrp(x, fs, mode), data, factors)
        assert got.is_cuda and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
        got, want = _both(lambda v, c, fs: sp_mttkrp(v, c, data.shape, fs, mode), vals, coords, factors)
        assert got.is_cuda
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
        dense = sp_full(torch.from_numpy(vals), torch.from_numpy(coords), data.shape)
        ref = mttkrp(dense, [torch.from_numpy(u) for u in factors], mode)
        np.testing.assert_allclose(want.numpy(), ref.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
def test_toolbox_cp_als_and_hooi_on_the_card(cuda_device):
    """20 sweeps from one init: the two fits within 1e-4."""
    from tritd_tpu_torch.ops import cp_als, tucker_hooi

    data, _, init = _toolbox_problem()
    got, want = _both(lambda x, fs: cp_als(x, 4, max_iters=20, tol=0.0, init_factors=fs), data, init)
    assert got["fit"].is_cuda and all(u.is_cuda for u in got["factors"])
    assert got["n_iters"] == want["n_iters"] == 20
    assert abs(float(got["fit"]) - float(want["fit"])) < 1e-4
    got, want = _both(lambda x: tucker_hooi(x, (4, 4, 4), max_iters=10, tol=0.0), data)
    assert got["core"].is_cuda and got["n_iters"] == 10
    assert abs(float(got["fit"]) - float(want["fit"])) < 1e-4
    for u, v in zip(got["factors"], want["factors"]):
        pu, pv = (u @ u.T).double().cpu(), v @ v.T
        assert float((pu - pv).abs().max()) < 1e-3


@pytest.mark.cuda
def test_toolbox_eig_sshopm_on_the_card(cuda_device):
    """The eigenvalue from one start: f32 on the card within 1e-4 of the
    f64 CPU run, and the f32 eigen-residual under 1e-3."""
    import itertools

    from tritd_tpu_torch.ops import eig_sshopm, ttsv

    rng = np.random.default_rng(2)
    a0 = rng.standard_normal((12,) * 4)
    # two symmetric rank-one terms over a symmetric noise floor: a clear
    # dominant eigenpair, so a small shift converges in tens of steps
    u = np.linalg.qr(rng.standard_normal((12, 2)))[0]
    a = 0.02 * sum(a0.transpose(p) for p in itertools.permutations(range(4))) / 24.0
    for w, col in zip((5.0, 3.0), u.T):
        a = a + w * np.einsum("i,j,k,l->ijkl", col, col, col, col)
    x0 = rng.standard_normal(12)
    got, want = _both(
        lambda t, x: (t, eig_sshopm(t, shift=1.0, max_iters=300, tol=1e-7, x0=x)), a, x0
    )
    (ta, got), (_, want) = got, want
    assert got["eigvec"].is_cuda
    assert abs(float(got["eigval"]) - float(want["eigval"])) < 1e-4 * max(1.0, abs(float(want["eigval"])))
    resid = ttsv(ta, got["eigvec"], 1) - got["eigval"] * got["eigvec"]
    assert float(torch.linalg.vector_norm(resid)) < 1e-3


@pytest.mark.cuda
def test_toolbox_classes_on_the_card(cuda_device):
    """The nine classes on float32 CUDA tensors against float64 CPU ones of
    the same numpy inputs: every result on the card, values within 1e-4 of
    the largest entry (bases through projectors)."""
    from tritd_tpu_torch.ops import classes as C

    data, factors, _init = _toolbox_problem()
    rng = np.random.default_rng(3)
    keep = rng.random(data.shape) < 0.3
    coords, vals = np.argwhere(keep), data[keep]
    core = rng.standard_normal((3, 3, 3))
    v = rng.standard_normal(data.shape[2])

    def calls(x, fs, c, sv, u0):
        t = C.Tensor(x)
        sp = C.SpTensor(sv, c, x.shape)
        k = C.KTensor(fs)
        tt = C.TTensor(u0, [f[:, :3] for f in fs])
        st = C.SumTensor([t, k, sp])
        return {
            "mttkrps": t.mttkrps(fs), "ttv": t.ttv(v_on(x), 2).data, "norm": t.norm(),
            "inner_k": t.innerprod(k), "inner_t": t.innerprod(tt), "inner_s": t.innerprod(sp),
            "inner_sum": t.innerprod(st), "tenmat": t.to_tenmat((1,)).to_tensor().data,
            "sp_mttkrp": sp.mttkrp(fs, 0), "sp_full": sp.full().data, "sp_ttm": sp.ttm(fs[1].T, 1).data,
            "sp_norm": sp.norm(), "k_full": k.full().data, "k_norm": k.norm(), "t_norm": tt.norm(),
            "sum_mttkrp": st.mttkrp(fs, 1), "sum_ttv": st.ttv(v_on(x), 2),
            "nvecs": t.nvecs(0, 3) @ t.nvecs(0, 3).T,
        }

    def v_on(x):
        return torch.as_tensor(v, dtype=x.dtype, device=x.device)

    got, want = _both(calls, data, factors, coords, vals, core)
    for key, w in want.items():
        g = got[key]
        for gi, wi in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
            assert gi.is_cuda, key
            np.testing.assert_allclose(gi.double().cpu().numpy(), wi.numpy(), rtol=0,
                                       atol=1e-4 * max(float(wi.abs().max()), 1e-30), err_msg=key)


@pytest.mark.cuda
def test_classes_built_from_numpy_default_to_the_card(cuda_device):
    from tritd_tpu_torch.ops import classes as C
    from tritd_tpu_torch.ops.kruskal import default_device

    assert default_device(None) == torch.device("cuda")
    assert C.Tensor(np.ones((2, 3))).data.is_cuda
    assert C.SpTensor(np.ones(1), np.zeros((1, 3), np.int64), (2, 2, 2)).coords.is_cuda
    assert C.Tensor(torch.ones(2)).data.device.type == "cpu"  # a tensor keeps its device


@pytest.mark.cuda
def test_symktensor_fg_autograd_on_the_card(cuda_device):
    from tritd_tpu_torch.ops import classes as C

    rng = np.random.default_rng(4)
    a = C.SymTensor(rng.standard_normal((6, 6, 6)), device="cuda")
    model = C.SymKTensor(rng.standard_normal(2), rng.standard_normal((6, 2)), 3, device="cuda")
    f, g = model.fg(model.fg_setup(a))
    vec = model.tovec().clone().requires_grad_(True)
    obj = ((a.data - C.SymKTensor.from_vec(vec, 6, 2, 3).full().data) ** 2).sum()
    (g_auto,) = torch.autograd.grad(obj, vec)
    assert g.is_cuda and g_auto.is_cuda
    np.testing.assert_allclose(float(f), float(obj.detach()), rtol=1e-10)
    np.testing.assert_allclose(g.cpu().numpy(), g_auto.cpu().numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_emulator_parity_tiny_in_float64_on_the_card(cuda_device):
    from tritd_tpu_torch.tools import emulator_parity

    prob = emulator_parity.tiny_problem()
    for method in emulator_parity.METHODS:
        row = emulator_parity.run(method, prob, emulator_parity.TINY_ITERS, device="cuda")
        assert row["pass"] and row["iters_match"], row
        assert row["max_abs_diff_err_hist"] < 1e-10, row
        want = {"f64": row["n_iters_port"]} if method == "triple" else {}
        assert row["kernel_launches"] == want, row


# --- the other solve loops on their graph route -----------------------------


@contextlib.contextmanager
def _watch(monkeypatch):
    """Counts, inside, the synchronizing calls (torch.cuda.set_sync_debug_mode's
    warnings, a checkpoint save's left out) and the graphs captured. Yields a
    dict that holds both after the block."""
    from tritd_tpu_torch.solvers import checkpointed

    seen = {"graphs": 0}

    class Counted(hopper_kernels.CountedGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["graphs"] += 1

    def save(path, state, real=checkpointed.save_state):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(path, state)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    monkeypatch.setattr(hopper_kernels, "CountedGraph", Counted)
    monkeypatch.setattr(checkpointed, "save_state", save)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield seen
        finally:
            torch.cuda.set_sync_debug_mode("default")
            monkeypatch.undo()
    seen["syncs"] = sum("called a synchronizing" in str(w.message) for w in caught)


def _bitwise(got, want, fields=("a", "b", "c", "o", "e", "err_hist", "rre_hist")):
    assert got.n_iters == want.n_iters
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), f


@pytest.mark.cuda
@pytest.mark.parametrize("every,fields", [(1, dict()), (4, dict()), (4, dict(unroll=3, storage_dtype="bfloat16"))],
                         ids=["every1", "every4", "every4_unroll3_bf16"])
def test_checkpointed_graph_route_is_the_eager_loop_bitwise(cuda_device, tmp_path, monkeypatch, every, fields):
    """One loop for the call, one iteration a replay whatever cfg.unroll:
    the result and the checkpoints bitwise the eager loop's; two captures in
    all; one synchronizing call when the loop is made, one after each
    iteration short of max_iter and one a segment (the penalties), the saves
    apart; one launch an iteration, all through the pointer entry."""
    from tritd_tpu_torch.solvers import checkpointed, tritd_admm_checkpointed

    y = torch.from_numpy(np.random.default_rng(6).standard_normal((20, 16, 24)) * 10).float().to(cuda_device)
    cfg = dataclasses.replace(COMPLETION_TRITD, **{"max_iter": 10, "tol": 0.0, **fields})
    init = init_factors(torch.Generator().manual_seed(0), tuple(y.shape), cfg.rank, torch.float32)
    hopper_kernels.reset_launch_counts()
    with _watch(monkeypatch) as seen:
        graph = tritd_admm_checkpointed(y, cfg, str(tmp_path / "graph"), every=every, init=init)
    segments = -(-cfg.max_iter // every)
    launches = {k: v for k, v in hopper_kernels.LAUNCHES.items() if v}
    pointer = {k: v for k, v in hopper_kernels.POINTER_LAUNCHES.items() if v}
    eager = checkpointed._solve(y, cfg, str(tmp_path / "eager"), every, init, None, True, graphs=None)
    _bitwise(graph, eager)
    assert graph.n_iters == cfg.max_iter and seen["graphs"] == 2
    assert seen["syncs"] == cfg.max_iter + segments
    assert sum(launches.values()) == sum(pointer.values()) == cfg.max_iter
    steps = sorted(os.listdir(tmp_path / "graph"))
    assert steps == sorted(os.listdir(tmp_path / "eager")) and len(steps) == segments
    for step in steps:
        with np.load(tmp_path / "graph" / step) as g, np.load(tmp_path / "eager" / step) as e:
            for name in e.files:
                assert g[name].tobytes() == e[name].tobytes(), (step, name)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["outlier", "outlier_early_stop", "als", "als_early_stop", "mals"])
def test_carried_loops_graph_route_is_the_eager_loop_bitwise(cuda_device, monkeypatch, solver):
    """The outlier solver, ALS and MALS: bitwise their eager loops; the
    outlier one captures two graphs (O and the duals alternate between two
    sets of buffers), ALS and MALS one; a read of the stop flag after each
    iteration short of max_iter and one of the counter at the end, MALS only
    the last."""
    from tritd_tpu_torch.solvers import als, outlier

    rng = np.random.default_rng(7)
    shape = (20, 16, 24)
    parts = [rng.standard_normal(s) for s in ((20, 3, 3), (3, 16, 3), (3, 3, 24))]
    x = np.einsum("iqs,qjs,qst->ijt", *parts)
    x = 10.0 * x / np.sqrt(np.mean(x**2)) + 0.05 * rng.standard_normal(shape)
    x = torch.from_numpy(x + (rng.random(shape) < 0.03) * 20.0).float().to(cuda_device)
    init = init_factors(torch.Generator().manual_seed(0), shape, 3, torch.float32)
    early = solver.endswith("early_stop")
    if solver.startswith("outlier"):
        cfg = OutlierConfig(rank=3, max_iter=30, tol=1e-2 if early else 0.0)

        def run(graphs):
            return outlier._outlier_run(x, cfg, init, None, graphs)
    else:
        cfg = TriTDConfig(rank=3, max_iter=30, tol=1e-2 if early else 0.0)

        def run(graphs):
            return als._als_run(x, cfg, solver == "mals", init, None, graphs)
    with _watch(monkeypatch) as seen:
        graph = run(True)
    eager = run(None)
    _bitwise(graph, eager)
    n = graph.n_iters
    assert (n < cfg.max_iter) == early
    assert seen["graphs"] == (2 if solver.startswith("outlier") else 1)
    assert seen["syncs"] == (1 if solver == "mals" else n + 1 if early else n)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pinv", "lstsq"])
def test_uncaptured_methods_take_the_eager_loop_on_the_card(cuda_device, tmp_path, monkeypatch, method):
    """`tritd_admm`, the sharded solve, the batched sharded solve (on a
    one-rank NCCL group, whose collectives the graph route would capture)
    and the other loops with solve_method "pinv" or "lstsq" run on the card
    without a capture, the kernel through its by-value entry (the batched
    one once an iteration); on the graph route the capture raises (in a
    subprocess, so that the failed capture cannot touch this process's
    card)."""
    from tritd_tpu_torch.parallel import tritd_admm_batch_sharded, tritd_admm_sharded
    from tritd_tpu_torch.solvers import tritd_admm_checkpointed

    y = torch.from_numpy(np.random.default_rng(8).standard_normal((20, 16, 24)) * 10).float().to(cuda_device)
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=4, tol=0.0, solve_method=method)
    hopper_kernels.reset_launch_counts()
    with _watch(monkeypatch) as seen:
        res = tritd_admm(y, cfg)
        tritd_admm_checkpointed(y, cfg, str(tmp_path), every=2)
        tritd_admm_outlier(y, OutlierConfig(max_iter=3, tol=0.0, solve_method=method))
        tritd_als(y, dataclasses.replace(cfg, max_iter=3))
        tritd_mals(y, dataclasses.replace(cfg, max_iter=3))
        with _one_nccl_rank() as mesh:
            sharded = tritd_admm_sharded(y, cfg, mesh)
            batch = tritd_admm_batch_sharded(torch.stack([y, y.flip(0)]), cfg, mesh)
    assert res.n_iters == sharded.n_iters == 4 and batch.n_iters.tolist() == [4, 4] and seen["graphs"] == 0
    assert hopper_kernels.LAUNCHES["elementwise_block[f32]"] == 12
    assert sum(hopper_kernels.BATCH_LAUNCHES.values()) == 4
    assert not any(hopper_kernels.POINTER_LAUNCHES.values())
    assert torch.isfinite(batch.err_hist).all() and torch.isfinite(sharded.err_hist).all()
    code = (
        "import dataclasses, torch\n"
        "from tritd_tpu_torch.solvers import admm, init_factors, init_state\n"
        "from tritd_tpu_torch.utils.config import COMPLETION_TRITD\n"
        "y = torch.randn(20, 16, 24, generator=torch.Generator().manual_seed(0)).cuda()\n"
        f"cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=4, tol=0.0, solve_method={method!r})\n"
        "state = init_state(y, cfg, init_factors(torch.Generator().manual_seed(0), (20, 16, 24), 5, torch.float32))\n"
        "admm._run_device_form(y, state, cfg, None, None, None, None, graphs=True)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=repo, timeout=300)
    assert proc.returncode != 0 and "captur" in proc.stderr, proc.stderr[-2000:]



# --- SOFIA's kernels and device loops ---------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 8, 9, 32])
def test_sofia_kernels_match_their_plain_versions(cuda_device, dtype, r):
    """pinv_rows within 64 r eps times each gram's condition of its row's
    scale of torch's pinv, an all-zero gram's row exactly zero; the sweep
    within 256 eps of its largest value of the row loop; one launch each;
    a rank past the limit raises."""
    from tritd_tpu_torch.ops import sofia_kernels

    g = torch.Generator().manual_seed(r)
    a = torch.randn((40, r, r), generator=g, dtype=torch.float64)
    gram = a @ a.transpose(1, 2) + 0.1 * torch.eye(r, dtype=torch.float64)
    gram[0] = 0.0
    gram[1] = torch.outer(a[1, 0], a[1, 0])
    rhs = torch.randn((40, r), generator=g, dtype=torch.float64)
    gram, rhs = gram.to(cuda_device, dtype), rhs.to(cuda_device, dtype)
    eps = torch.finfo(dtype).eps
    rtol = 10.0 * r * eps
    hopper_kernels.reset_launch_counts()
    got = sofia_kernels.pinv_rows(rhs, gram, rtol)
    want = sofia_kernels.pinv_rows_torch(rhs, gram, rtol)
    tag = "f32" if dtype == torch.float32 else "f64"
    assert hopper_kernels.SOFIA_LAUNCHES[f"pinv_rows[{tag}]"] == 1
    assert torch.equal(got[0], torch.zeros_like(got[0])) and torch.isfinite(got).all()
    lam = torch.linalg.eigvalsh(gram.double()).abs()
    kept = torch.where(lam > rtol * lam.amax(-1, keepdim=True), lam, torch.full_like(lam, float("inf")))
    cond = torch.where(torch.isfinite(kept.amin(-1)), lam.amax(-1) / kept.amin(-1), torch.ones_like(lam[:, 0]))
    err = (got - want).abs().amax(-1).double()
    assert (err <= 64 * r * eps * cond * want.abs().amax(-1).double()).all()
    n3, m = 300, 7
    rhs0 = torch.randn((n3, r), generator=g, dtype=torch.float64)
    b = torch.randn((n3, r, r), generator=g, dtype=torch.float64)
    inv = torch.linalg.inv(b @ b.transpose(1, 2) + 2.0 * torch.eye(r, dtype=torch.float64)).contiguous()
    rhs0, inv = rhs0.to(cuda_device, dtype), inv.to(cuda_device, dtype)
    got = sofia_kernels.gauss_seidel_sweep(rhs0, inv, 0.1, 0.001, m)
    want = sofia_kernels.gauss_seidel_sweep_torch(rhs0, inv, 0.1, 0.001, m)
    assert hopper_kernels.SOFIA_LAUNCHES[f"gauss_seidel_sweep[{tag}]"] == 1
    assert float((got - want).abs().max()) <= 256 * eps * float(want.abs().max())
    too_wide = sofia_kernels.MAX_RANK + 1
    with pytest.raises(ValueError, match=f"ranks 1 to {sofia_kernels.MAX_RANK}"):
        sofia_kernels.pinv_rows(torch.zeros((2, too_wide), device=cuda_device, dtype=dtype),
                                torch.zeros((2, too_wide, too_wide), device=cuda_device, dtype=dtype), rtol)


SWEEP_EPS_FACTOR = 256  # the mode-3 step against its plain version, eps of its largest value


def _mode3_inputs(n3, r, dtype, device, seed=0):
    """(u3, rhs_base, gram_base): old rows, right-hand sides and grams whose
    systems are well conditioned (eigenvalues about 0.5 to 3)."""
    g = torch.Generator().manual_seed(seed + r)
    b = torch.randn((n3, r, 2 * r), generator=g, dtype=torch.float64)
    gram = b @ b.transpose(1, 2) / (2 * r) + 0.5 * torch.eye(r, dtype=torch.float64)
    return tuple(x.to(device, dtype).contiguous() for x in (
        torch.randn((n3, r), generator=g, dtype=torch.float64), torch.randn((n3, r), generator=g, dtype=torch.float64),
        gram))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("m", [1, 2, 3, 7, 300], ids=["m1", "m2", "m3", "m7", "m_past_n3"])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 8, 17, 32])
def test_mode3_sweep_matches_its_plain_version(cuda_device, dtype, r, m):
    """The whole mode-3 step in one launch within SWEEP_EPS_FACTOR eps of its
    largest value of the systems and the row loop (`mode3_sweep_torch`).
    Each coupling of the one-thread chain is met: none (m >= n3), row t - 1
    (m = 1), a row still in registers (m = 2, and m = 3 where it keeps three
    rows ahead: float32 r <= 4, float64 r <= 3) and the delay line in shared
    memory (m = 7, and m = 3 where it keeps two)."""
    from tritd_tpu_torch.ops import sofia_kernels

    n3, tag = 300, "f32" if dtype == torch.float32 else "f64"
    args = _mode3_inputs(n3, r, dtype, cuda_device)
    hopper_kernels.reset_launch_counts()
    got = sofia_kernels.mode3_sweep(*args, 0.1, 0.001, m)
    assert hopper_kernels.SOFIA_LAUNCHES == {**dict.fromkeys(hopper_kernels.SOFIA_LAUNCHES, 0), f"mode3_sweep[{tag}]": 1}
    want = sofia_kernels.mode3_sweep_torch(*args, 0.1, 0.001, m)
    assert got.shape == want.shape and torch.isfinite(got).all()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= SWEEP_EPS_FACTOR * torch.finfo(dtype).eps * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("r", [3, 5])
def test_the_one_thread_chain_reads_its_own_rows_where_the_delay_line_does_not_fit(cuda_device, dtype, r):
    """m = 8500 rows back at r = 3 and 5 (one thread's chain in both dtypes):
    a power of two of m staged rows, 16384 of 16 bytes or more, passes the
    shared memory a block may hold, and the chain reads the rows m back from
    its own stores in out."""
    from tritd_tpu_torch.ops import sofia_kernels

    args = _mode3_inputs(9000, r, dtype, cuda_device, seed=6)
    got = sofia_kernels.mode3_sweep(*args, 0.1, 0.001, 8500)
    want = sofia_kernels.mode3_sweep_torch(*args, 0.1, 0.001, 8500)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= SWEEP_EPS_FACTOR * torch.finfo(dtype).eps * float(want.abs().max())


@pytest.mark.cuda
def test_mode3_sweep_reads_its_own_rows_where_the_delay_line_does_not_fit(cuda_device):
    """r = 32 in float64 at network's period: the m rows back do not fit in
    shared memory beside the tiles, and the chain reads its own stores."""
    from tritd_tpu_torch.ops import sofia_kernels

    args = _mode3_inputs(500, 32, torch.float64, cuda_device, seed=5)
    got = sofia_kernels.mode3_sweep(*args, 0.1, 0.001, 168)
    want = sofia_kernels.mode3_sweep_torch(*args, 0.1, 0.001, 168)
    assert float((got - want).abs().max()) <= SWEEP_EPS_FACTOR * torch.finfo(torch.float64).eps * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("r", [4, 17])
def test_mode3_sweep_turns_the_rows_nan_from_a_system_it_cannot_factor(cuda_device, dtype, r):
    from tritd_tpu_torch.ops import sofia_kernels

    n3, bad = 200, 77
    u3, rhs, gram = _mode3_inputs(n3, r, dtype, cuda_device, seed=2)
    gram[bad] -= 50.0 * torch.eye(r, dtype=dtype, device=cuda_device)
    got = sofia_kernels.mode3_sweep(u3, rhs, gram, 0.1, 0.001, 7)
    want = sofia_kernels.mode3_sweep_torch(u3, rhs, gram, 0.1, 0.001, 7)
    assert torch.isnan(got[bad:]).all() and torch.isnan(want[bad:]).all() and torch.isfinite(got[:bad]).all()
    err = float((got[:bad] - want[:bad]).abs().max())
    assert err <= SWEEP_EPS_FACTOR * torch.finfo(dtype).eps * float(want[:bad].abs().max())


@pytest.mark.cuda
def test_sofia_init_at_rank_four_takes_the_graph_route_bitwise(cuda_device, monkeypatch):
    """Above r = 3 the mode-3 step is the kernel too, so SOFIA replays its
    graphs: sofia_init on the taxi stand-in at r = 4 (2 epochs), at most
    three captures, bitwise the same programs without graphs, one mode3_sweep
    launch an ALS iteration."""
    from tritd_tpu_torch.baselines import sofia
    from tritd_tpu_torch.data import load_dataset

    x_np, spec, _prov = load_dataset("taxi")
    x = torch.as_tensor(x_np, dtype=torch.float32, device=cuda_device)
    mask = torch.as_tensor(np.random.default_rng(0).random(x_np.shape) > 0.1, device=cuda_device)
    init = tuple(torch.rand((n, 4), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
                 for n in x_np.shape)
    args = (x, mask, 4, spec.sofia_period, 0.1, 0.001, 10.0, x, 2, 1e-3, 300, None, init)
    assert sofia._graph_route(cuda_device, 4)
    hopper_kernels.reset_launch_counts()
    with _watch(monkeypatch) as seen:
        graph = sofia._init_run(*args, True)
    launches = dict(hopper_kernels.SOFIA_LAUNCHES)
    eager = sofia._init_run(*args, False)
    assert 1 <= seen["graphs"] <= 3 and len(graph[3]) == 2
    for a, b in zip((*graph[0], graph[1], graph[2]), (*eager[0], eager[1], eager[2])):
        assert torch.equal(a, b)
    assert np.array_equal(graph[3], eager[3])
    assert launches["mode3_sweep[f32]"] > 0 and launches["pinv_rows[f32]"] == 2 * launches["mode3_sweep[f32]"]
    assert launches["gauss_seidel_sweep[f32]"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [7, 1], ids=["traffic", "video_m1"])
def test_sofia_graph_routes_are_their_device_forms_bitwise(cuda_device, monkeypatch, m):
    """sofia_init (at most three captures a call: the ALS start, an ALS
    iteration, the epoch step), the ALS loop alone (one capture) and the
    stream (one capture) on the graph route: bitwise the same device
    programs without graphs; the public entry points take the graph route
    on the card."""
    from tritd_tpu_torch.baselines import sofia

    spec = DatasetSpec("tiny", "traffic", "T", (16, 14, 28), sofia_period=m)
    x = torch.from_numpy(synthetic_traffic(spec, np.random.default_rng(3))).float().to(cuda_device)
    mask = torch.from_numpy(np.random.default_rng(4).random(spec.shape) > 0.1).to(cuda_device)
    init = tuple(torch.rand((n, 3), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
                 for n in spec.shape)
    args = (x, mask, 3, m, 0.1, 0.001, 10.0, x, 6, 0.0, 300, None, init)
    with _watch(monkeypatch) as seen:
        graph = sofia._init_run(*args, True)
    eager = sofia._init_run(*args, False)
    public = sofia.sofia_init(x, mask, 3, m, origin=x, max_epoch=6, tol=0.0, u_init=init)
    assert 1 <= seen["graphs"] <= 3 and len(graph[3]) == 6
    for got in (eager, public):
        for a, b in zip((*graph[0], graph[1], graph[2]), (*got[0], got[1], got[2])):
            assert torch.equal(a, b)
        assert np.array_equal(graph[3], got[3])
    u = tuple(v.to(cuda_device).float() for v in init)
    with _watch(monkeypatch) as seen:
        als_graph = sofia._als_loop(x, mask, *u, m, 0.1, 0.001, 12, 0.0, graphs=True)
    assert seen["graphs"] == 1
    for a, b in zip(als_graph, sofia._als_loop(x, mask, *u, m, 0.1, 0.001, 12, 0.0, graphs=False)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(5)
    n1, n2, r, frames = 16, 14, 3, 20
    state = tuple(torch.from_numpy(v).float().to(cuda_device) for v in (
        rng.random((frames, n1, n2)), (rng.random((frames, n1, n2)) > 0.1).astype(np.float64), rng.random((n1, r)),
        rng.random((n2, r)), rng.random((m, r)) + 1.0, rng.random(r) + 1.0, 0.01 * rng.random(r),
        0.1 * rng.random((m, r)), np.full((3, r), 0.2), np.full((n1, n2), 0.1)))
    with _watch(monkeypatch) as seen:
        stream = sofia._stream_scan(*state, m, 0.1, 0.001, 0.1, 0.05, True, True)
    assert seen["graphs"] == 1 and seen["syncs"] == 1  # the frame counter, read at the end
    for a, b in zip(stream, sofia._stream_scan(*state, m, 0.1, 0.001, 0.1, 0.05, True, False)):
        assert torch.equal(a, b)


# --- the Tensor Toolbox's loops on their graph route ------------------------

# cp_als_sparse's routes on the card: |fit difference| and the largest
# difference of the reconstructions over their largest entry, after 40
# sweeps at tol 0. `index_add_` adds atomically, in an order that changes
# from run to run; a float32 MTTKRP is held to 1e-4 of its largest entry
# above for the same reason.
SPARSE_ROUTE_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("stop", ["early", "tol0"])
@pytest.mark.parametrize("name", toolbox_cases.NAMES)
def test_toolbox_loops_graph_route_is_the_device_form(cuda_device, monkeypatch, name, stop):
    """f32 on the card: the public call takes the graph route (one
    capture) and is bitwise the device form without graphs, at a tol that
    stops early and at tol 0 (cp_als_sparse at tol 0 within
    SPARSE_ROUTE_TOL); synchronizing calls: the flag after each iteration
    short of max_iters, the counter at the end, and for cp_arls the copy of
    its draws to the card."""
    from tritd_tpu_torch.ops import ktensor_full, toolbox_loop

    tol = toolbox_cases.EARLY_TOL[name] if stop == "early" else 0.0
    data = toolbox_cases.on_device(toolbox_cases.inputs(), cuda_device, torch.float32)
    toolbox_cases.call(name, tol, data=data, max_iters=3)  # the libraries' set-up outside the watch
    with _watch(monkeypatch) as seen:
        graph = toolbox_cases.call(name, tol, data=data)
    with toolbox_loop.forced_route(False):
        plain = toolbox_cases.call(name, tol, data=data)
    n, cap = graph["n_iters"], toolbox_cases.MAX_ITERS[name]
    assert seen["graphs"] == 1 and (2 <= n < cap if stop == "early" else n == cap)
    assert seen["syncs"] == (n + 1 if n < cap else n) + (name == "cp_arls")
    assert all(t.is_cuda for t in toolbox_cases.tensors(graph).values())
    if name != "cp_als_sparse":
        assert toolbox_cases.same_bits(graph, plain) == []
    elif stop == "tol0":
        assert plain["n_iters"] == n
        assert abs(float(graph["fit"]) - float(plain["fit"])) <= SPARSE_ROUTE_TOL
        g, p = (ktensor_full(r["factors"], r["weights"]).double() for r in (graph, plain))
        assert float((g - p).abs().max() / p.abs().max()) <= SPARSE_ROUTE_TOL


@pytest.mark.cuda
def test_toolbox_loop_capture_that_meets_a_host_sync_raises(cuda_device, monkeypatch):
    """A read back to the host inside a Toolbox loop's iteration fails its
    capture, which raises (no fallback to another route); the card is
    usable after it."""
    from tritd_tpu_torch.ops import decomp

    real = decomp._kruskal_fit

    def syncing(norm_x, factors, inner):
        float(inner)
        return real(norm_x, factors, inner)

    data = toolbox_cases.on_device(toolbox_cases.inputs(), cuda_device, torch.float32)
    monkeypatch.setattr(decomp, "_kruskal_fit", syncing)
    with pytest.raises(RuntimeError, match="capturing"):
        toolbox_cases.call("cp_als", 0.0, data=data)
    monkeypatch.setattr(decomp, "_kruskal_fit", real)
    assert toolbox_cases.call("cp_als", 0.0, data=data)["n_iters"] == toolbox_cases.MAX_ITERS["cp_als"]


# --- the SVT baselines' loops and tucker_hooi on the card: ops/device_linalg.py,
# baselines/device_loop.py ---------------------------------------------------


def _captured(fn):
    """fn() captured as a CUDA graph on a side stream after one eager call
    there, replayed once: the captured call's outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    out = []
    with torch.cuda.stream(side):
        fn()
        graph = hopper_kernels.CountedGraph(lambda: out.append(fn()), torch.cuda.graph_pool_handle())
        graph.replay()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [100, 300, 500, 512, 1000])
def test_device_eigh_matches_torch_linalg_and_captures(cuda_device, n, dtype):
    """The binding's eigh on a Gram against torch.linalg.eigh: bitwise where
    it takes torch's driver, else eigenvalues and the reconstruction within
    64 n eps ||A||; up to n = 512 a CUDA graph captures it, and its replay
    gives the eager call's bits (past it the driver is Xsyevd, torch's,
    which no graph captures)."""
    from tritd_tpu_torch.ops import device_linalg

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    m = torch.randn((n, 2 * n), generator=gen, device=cuda_device, dtype=dtype)
    a = m @ m.T
    w, v = device_linalg.eigh(a)
    tw, tv = torch.linalg.eigh(a)
    bound = 64 * n * torch.finfo(dtype).eps * float(torch.linalg.matrix_norm(a, 2))
    if device_linalg.eigh_driver(n, dtype) == device_linalg.torch_eigh_driver(n, dtype):
        assert torch.equal(w, tw) and torch.equal(v, tv)
    assert float((w - tw).abs().max()) <= bound
    assert float(torch.linalg.matrix_norm((v * w) @ v.T - a)) <= bound
    if device_linalg.eigh_captures(n):
        cw, cv = _captured(lambda: device_linalg.eigh(a))
        assert torch.equal(cw, w) and torch.equal(cv, v)
    else:
        assert device_linalg.eigh_driver(n, dtype) == device_linalg.torch_eigh_driver(n, dtype) == "xsyevd"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(100, 5000), (3000, 200), (200, 200), (1100, 1300)], ids=str)
def test_device_svd_matches_torch_linalg(cuda_device, shape, dtype):
    """The binding's thin SVD against torch.linalg.svd: bitwise where it
    takes torch's driver (gesvdj, past SVD_JACOBI_MAX_K), else singular
    values and the reconstruction within 64 k eps s_max (the Jacobi SVD);
    captured and replayed bitwise where the driver can be captured
    (`device_linalg.svd_captures`)."""
    from tritd_tpu_torch.ops import device_linalg

    p, q = shape
    gen = torch.Generator(device=cuda_device).manual_seed(p + q)
    a = torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)
    hopper_kernels.reset_launch_counts()
    u, s, vh = device_linalg.svd(a)
    tu, ts, tvh = torch.linalg.svd(a, full_matrices=False)
    assert u.shape == tu.shape and vh.shape == tvh.shape
    bound = 64 * min(shape) * torch.finfo(dtype).eps * float(ts.max())
    driver = device_linalg.svd_driver(p, q, dtype)
    tag = "f32" if dtype == torch.float32 else "f64"
    if driver == "gesvdj":
        assert torch.equal(u, tu) and torch.equal(s, ts) and torch.equal(vh, tvh)
        assert hopper_kernels.LINALG_CALLS[f"gesvdj[{tag}]"] == 1
    else:
        assert driver == "jacobi" and hopper_kernels.JACOBI_SVD_LAUNCHES[f"jacobi_svd[{tag}]"] == 1
    assert float((s - ts).abs().max()) <= bound
    assert float(torch.linalg.matrix_norm((u * s) @ vh - a)) <= bound
    if device_linalg.svd_captures(p, q):
        cu, cs, cvh = _captured(lambda: device_linalg.svd(a))
        assert torch.equal(cu, u) and torch.equal(cs, s) and torch.equal(cvh, vh)
    else:
        assert driver == "gesvdj"


def _svd_held(a, u, s, vh, ref):
    """(u, s, vh) of `a` against `ref`, torch.linalg.svd of `a` in float64:
    singular values within JACOBI_LIMITS s_max, the reconstruction's
    Frobenius norm within that times sqrt(k), both sides orthonormal within
    sqrt(k) eps + JACOBI_LIMITS (on the columns of nonzero singular
    values)."""
    from tritd_tpu_torch.ops import device_linalg

    k = min(a.shape)
    bound = JACOBI_LIMITS[a.dtype]
    smax = float(ref[1][0])
    u, s, vh = u.double(), s.double(), vh.double()
    assert float((s - ref[1]).abs().max()) <= bound * smax
    assert float(torch.linalg.matrix_norm((u * s) @ vh - a.double())) <= bound * smax * k ** 0.5
    keep = s > 0
    for basis in (u[:, keep], vh[keep].mT):
        eye = torch.eye(basis.shape[1], dtype=torch.float64, device=a.device)
        assert float((basis.mT @ basis - eye).abs().max()) <= device_linalg.jacobi_tol(k, a.dtype) + bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(100, 50000), (10000, 500), (5000, 1000), (1000, 5000)], ids=str)
def test_jacobi_svd_matches_its_plain_version_and_torch(cuda_device, shape, dtype):
    """The kernel at the taxi unfoldings' shapes (a low-rank matrix plus
    noise, as the SVT sees) against its plain version on the same tensor
    and torch.linalg.svd in float64 (`_svd_held`); one launch a call; a
    captured call replayed twice gives the eager call's bits."""
    from tritd_tpu_torch.ops import device_linalg

    p, q = shape
    gen = torch.Generator(device=cuda_device).manual_seed(p * 7 + q)
    a = (torch.randn((p, 10), generator=gen, device=cuda_device, dtype=dtype)
         @ torch.randn((10, q), generator=gen, device=cuda_device, dtype=dtype) * 10
         + torch.randn((p, q), generator=gen, device=cuda_device, dtype=dtype))
    ref = torch.linalg.svd(a.double(), full_matrices=False)
    hopper_kernels.reset_launch_counts()
    capped = device_linalg.jacobi_capped(a.device)
    capped.zero_()
    u, s, vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
    tag = "f32" if dtype == torch.float32 else "f64"
    assert hopper_kernels.JACOBI_SVD_LAUNCHES[f"jacobi_svd[{tag}]"] == 1
    assert 1 < int(sweeps) < device_linalg.JACOBI_SWEEPS and int(capped) == 0
    assert u.dtype == s.dtype == vh.dtype == dtype and u.is_cuda
    _svd_held(a, u, s, vh, ref)
    pu, ps, pvh = device_linalg.jacobi_svd_torch(a)
    _svd_held(a, pu, ps, pvh, ref)
    assert float((s.double() - ps.double()).abs().max()) <= 2 * JACOBI_LIMITS[dtype] * float(ref[1][0])
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        device_linalg.jacobi_svd(a)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        cu, cs, cvh = device_linalg.jacobi_svd(a)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(cu, u) and torch.equal(cs, s) and torch.equal(cvh, vh)


@pytest.mark.cuda
def test_a_jacobi_svd_stopped_at_its_cap_is_counted_and_fails_the_loop(cuda_device, monkeypatch):
    """With the cap lowered to one sweep, a call that still rotates in it
    adds one to `jacobi_capped` (a replay too), a converged one nothing, and
    trpca_snn's device loop raises at its segment's end."""
    from tritd_tpu_torch.baselines import trpca
    from tritd_tpu_torch.ops import device_linalg

    a = torch.randn((300, 40), generator=torch.Generator(device=cuda_device).manual_seed(3), device=cuda_device)
    capped = device_linalg.jacobi_capped(cuda_device)
    capped.zero_()
    device_linalg.jacobi_svd(a)
    assert int(capped) == 0
    monkeypatch.setattr(device_linalg, "JACOBI_SWEEPS", 1)
    _u, _s, _vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
    assert int(sweeps) == 1 and int(capped) == 1
    _captured(lambda: device_linalg.jacobi_svd_with_sweeps(a))  # jacobi_svd's eager call would raise
    assert int(capped) == 3  # the eager call before the capture and the replay
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((12, 10, 16))).float().to(cuda_device)
    with pytest.raises(RuntimeError, match="stopped at 1 sweeps"):
        trpca.trpca_snn(x, alpha=(1.0, 0.8, 1.2), mu=1e-3, max_iter=4)


@pytest.mark.cuda
def test_an_eager_jacobi_svd_at_its_cap_raises(cuda_device, monkeypatch):
    """The first departure from the reference's jnp.linalg.svd, which
    returns unconverged factors: an eager call on the card that stops at
    its cap still rotating reads its flag and raises, naming the cap; the
    same call under a capture reads nothing and only counts (the second
    departure: its loop raises at the segment's end,
    test_a_jacobi_svd_stopped_at_its_cap_is_counted_and_fails_the_loop);
    inside `caller_reads_the_cap` it reads nothing either; a converged
    call returns."""
    from tritd_tpu_torch.ops import device_linalg

    a = torch.randn((300, 40), generator=torch.Generator(device=cuda_device).manual_seed(3), device=cuda_device)
    device_linalg.jacobi_svd(a)
    monkeypatch.setattr(device_linalg, "JACOBI_SWEEPS", 2)
    capped = device_linalg.jacobi_capped(cuda_device)
    capped.zero_()
    with pytest.raises(RuntimeError, match="stopped at its cap of 2 sweeps"):
        device_linalg.jacobi_svd(a)
    with device_linalg.caller_reads_the_cap():
        device_linalg.jacobi_svd(a)
    assert int(capped) == 2
    device_linalg.jacobi_svd(torch.eye(40, device=cuda_device))  # converges in one sweep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["graded", "clustered", "rank-def", "normal"])
def test_jacobi_svd_on_the_cap_readings_spectra(cuda_device, case, dtype):
    """The kernel on the spectra its cap was set from (`tools/jacobi_sweeps`;
    "normal": a standard normal matrix) at 3000 x 300, against its plain
    version on the same tensor and torch.linalg.svd in float64
    (`_svd_held`, JACOBI_LIMITS): it converges under the cap, as the plain
    version does, their singular values within twice the limit."""
    from tritd_tpu_torch.ops import device_linalg
    from tritd_tpu_torch.tools import jacobi_sweeps

    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "normal":
        a_np = rng.standard_normal((3000, 300))
    else:
        a_np = jacobi_sweeps._with_spectrum(3000, 300, jacobi_sweeps.spectrum(case, 300, np.finfo(np.float64).eps), rng)
    a = torch.from_numpy(a_np).to(dtype).to(cuda_device)
    ref = torch.linalg.svd(a.double(), full_matrices=False)
    u, s, vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
    _pu, ps, _pvh, plain_sweeps = device_linalg._jacobi_torch(a)
    assert 1 < int(sweeps) < device_linalg.JACOBI_SWEEPS and plain_sweeps < device_linalg.JACOBI_SWEEPS
    _svd_held(a, u, s, vh, ref)
    assert float((s.double() - ps.double()).abs().max()) <= 2 * JACOBI_LIMITS[dtype] * float(ref[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_a_jacobi_svd_call_is_five_launches(cuda_device, dtype):
    """One call is one count in JACOBI_SVD_LAUNCHES and, by the library's
    own launch counts (`tritd_jacobi_launches`), the five kernels of
    `device_linalg.JACOBI_KERNELS`, each once, whatever its sweeps: they
    run in one launch."""
    from tritd_tpu_torch.ops import device_linalg
    from tritd_tpu_torch.tools import jacobi_sweeps

    a = torch.randn((2000, 200), generator=torch.Generator(device=cuda_device).manual_seed(4), device=cuda_device,
                    dtype=dtype)
    device_linalg.jacobi_svd(a)
    hopper_kernels.reset_launch_counts()
    assert jacobi_sweeps.kernels_a_call(lambda: device_linalg.jacobi_svd(a)) == {
        name: 1 for name in device_linalg.JACOBI_KERNELS}
    assert hopper_kernels.JACOBI_SVD_LAUNCHES == {"jacobi_svd[f32]": int(dtype == torch.float32),
                                                   "jacobi_svd[f64]": int(dtype == torch.float64)}


@pytest.mark.cuda
def test_jacobi_svd_of_a_zero_and_a_rank_one_matrix(cuda_device):
    """A zero matrix: zero singular values, its tall-side vectors zero, the
    other side the identity (no rotation); a rank-one matrix: one value.
    This rank-one matrix (every column an exact multiple of one) is one the
    sweeps did not converge on before the rotation test's floor (its
    columns of rounding noise rotated against the large one in every
    sweep, ROADMAP.md queue 3): now it converges under the cap, the eager
    jacobi_svd returns, and its result is held to its plain version and to
    torch.linalg.svd in float64."""
    from tritd_tpu_torch.ops import device_linalg

    u, s, vh = device_linalg.jacobi_svd(torch.zeros((70, 20), device=cuda_device))
    assert torch.equal(s, torch.zeros_like(s)) and torch.equal(u, torch.zeros_like(u))
    assert torch.equal(vh, torch.eye(20, device=cuda_device))
    x = torch.arange(1.0, 41.0, device=cuda_device, dtype=torch.float64)
    a = x[:, None] * x[None, :30]
    capped = device_linalg.jacobi_capped(cuda_device)
    capped.zero_()
    u, s, vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
    assert 1 < int(sweeps) < device_linalg.JACOBI_SWEEPS and int(capped) == 0
    ref = torch.linalg.svd(a, full_matrices=False)
    assert float((s - ref[1]).abs().max()) <= 1e-12 * float(ref[1][0])
    assert float(torch.linalg.matrix_norm((u * s) @ vh - a)) <= 1e-12 * float(torch.linalg.matrix_norm(a))
    eu, es, evh = device_linalg.jacobi_svd(a)
    assert torch.equal(eu, u) and torch.equal(es, s) and torch.equal(evh, vh)
    pu, ps, pvh = device_linalg.jacobi_svd_torch(a)
    assert float((s - ps).abs().max()) <= 2 * JACOBI_LIMITS[torch.float64] * float(ref[1][0])
    assert float(torch.linalg.matrix_norm((pu * ps) @ pvh - (u * s) @ vh)) <= 1e-12 * float(ref[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["outer 40x30", "outer 30x40", "static 60x40", "static 3000x100", "rank3 50x30",
                                  "zero-cols 40x24"])
def test_jacobi_svd_converges_on_exactly_rank_deficient_matrices(cuda_device, name, dtype):
    """The exact families (`tools/jacobi_sweeps.EXACT_SMALL`: an integer
    outer product and its transpose, static clips, rank 3 from duplicated
    columns, zero columns) on the card: the kernel converges within
    LAPACK's 30 sweeps, `jacobi_capped` stays 0, the eager call returns,
    and the result is held to torch.linalg.svd in float64 (`_svd_held`)
    and to its plain version (singular values within twice JACOBI_LIMITS,
    the same values zero)."""
    from tritd_tpu_torch.ops import device_linalg
    from tritd_tpu_torch.tools import jacobi_sweeps

    a = torch.from_numpy(jacobi_sweeps.exact_small(name)).to(dtype).to(cuda_device)
    ref = torch.linalg.svd(a.double(), full_matrices=False)
    capped = device_linalg.jacobi_capped(cuda_device)
    capped.zero_()
    u, s, vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
    assert int(sweeps) <= LAPACK_SWEEPS and int(capped) == 0
    _svd_held(a, u, s, vh, ref)
    device_linalg.jacobi_svd(a)
    _pu, ps, _pvh, plain_sweeps = device_linalg._jacobi_torch(a)
    assert plain_sweeps <= LAPACK_SWEEPS
    assert float((s.double() - ps.double()).abs().max()) <= 2 * JACOBI_LIMITS[dtype] * float(ref[1][0])
    assert torch.equal(s == 0, ps == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96000, 240), (76800, 300)], ids=str)
def test_jacobi_svd_float32_at_the_video_tall_forms(cuda_device, shape):
    """Zero columns among standard normal ones (every fifth column zero) at
    the video cut's tall forms, float32: the kernel converges (capped 0)
    and its singular values are within 2e-6 s_max of torch.linalg.svd of
    the same matrix in float64. With the rotation test's tolerance growing
    as sqrt(m) they read 5.5e-6 and 4.6e-6 (PERF.md section 6)."""
    from tritd_tpu_torch.ops import device_linalg
    from tritd_tpu_torch.tools import jacobi_sweeps

    a_np = jacobi_sweeps.exact_matrix("zero-cols", *shape, np.random.default_rng(0))
    a = torch.from_numpy(a_np).float().to(cuda_device)
    want = torch.linalg.svdvals(a.double())
    capped = device_linalg.jacobi_capped(cuda_device)
    capped.zero_()
    _u, s, _vh, sweeps = device_linalg.jacobi_svd_with_sweeps(a)
    assert int(sweeps) < device_linalg.JACOBI_SWEEPS and int(capped) == 0
    assert float((s.double() - want).abs().max()) <= 2e-6 * float(want[0])


BASELINE_LOOP_CASES = ["ttnn gram", "ttnn warm:4", "ring gram", "ring warm:4", "fctn gram", "fctn warm:4",
                       "fctn video lowrank:16", "ttnn svd", "ring svd", "fctn svd", "ttnn svd static",
                       "ring svd static"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BASELINE_LOOP_CASES)
def test_baseline_loops_graph_route_is_the_device_form(cuda_device, monkeypatch, case):
    """f32 on the card at (24, 20, 32), the warm threshold lowered to 8: the
    public call takes the graph route, one capture (two on a warm route:
    refresh and reuse), no synchronizing call in the loop but one read of
    the counter a segment (fctn's traffic chunks of 25: two in 30
    iterations), bitwise the device form without graphs, every eigh or SVD
    through the binding (on the svd route the Jacobi SVD, no gesvdj). A
    "static" case is a static clip under the video presets: every frame
    the first, nothing missing, so that the SVT's unfoldings are exactly
    rank-deficient (rank one past the first iteration); no Jacobi SVD
    stops at its cap (the segment's read would raise)."""
    from tritd_tpu_torch.baselines import device_loop
    from tritd_tpu_torch.ops import device_linalg, toolbox_loop

    method, *rest = case.split()
    video, static = "video" in rest, "static" in rest
    svt_method = next(word for word in rest if word not in ("video", "static"))
    spec = DatasetSpec("tiny", "video" if video or static else "traffic", "T", (24, 20, 32), fctn_subdim=4,
                       sofia_period=4)
    x = torch.from_numpy(synthetic_traffic(spec, np.random.default_rng(1))).float().to(cuda_device)
    mask = torch.from_numpy(np.random.default_rng(2).random(spec.shape) > 0.1).to(cuda_device)
    if static:
        x = x[:, :, :1].expand(spec.shape).contiguous()
        mask = torch.ones_like(mask)
    y = torch.where(mask, x, torch.zeros_like(x))
    iters = 30 if method == "fctn" else 10

    def call():
        return run_method(method, y, x, mask, spec, torch.Generator().manual_seed(0), iters, svt_method=svt_method)

    monkeypatch.setattr(svt_ops, "WARM_MIN_DIM", 8)
    with toolbox_loop.forced_route(False):
        plain = call()
    loop_syncs, real_run = [], device_loop.run

    def run(*args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = real_run(*args, **kwargs)
        loop_syncs.append(sum("called a synchronizing" in str(w.message) for w in caught))
        return out

    hopper_kernels.reset_launch_counts()
    capped = device_linalg.jacobi_capped(cuda_device)
    capped.zero_()
    with _watch(monkeypatch) as seen:
        monkeypatch.setattr(svt_ops, "WARM_MIN_DIM", 8)
        monkeypatch.setattr(device_loop, "run", run)
        graph = call()
    assert int(capped) == 0
    segments = 2 if method == "fctn" and (video or svt_method.startswith("warm")) else 1
    assert seen["graphs"] == (2 if svt_method.startswith("warm") else 1)
    assert loop_syncs == [segments]
    if svt_method == "svd":
        assert hopper_kernels.JACOBI_SVD_LAUNCHES["jacobi_svd[f32]"] > 0
        assert not any(hopper_kernels.LINALG_CALLS.values())
    else:
        assert any(n for n in hopper_kernels.LINALG_CALLS.values())
    assert graph[0].is_cuda and np.isfinite(graph[2]).all() and graph[2].shape == (iters,)
    for g, p in zip(graph, plain):
        g, p = torch.as_tensor(g), torch.as_tensor(p)
        assert torch.equal(g.nan_to_num(), p.nan_to_num()) and torch.equal(g.isnan(), p.isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fctn gram", "ttnn warm:4", "hooi", "ttnn svd"])
def test_a_loop_whose_eigh_no_graph_captures_takes_the_eager_loop(cuda_device, monkeypatch, case):
    """With the captured eigh's limit lowered to n = 8 (the Jacobi SVD's to
    a thin side of 8), the baselines' loops and tucker_hooi at small shapes
    have eighs (SVDs) past it, on Xsyevd (gesvdj): the public call takes the
    eager loop on the card (no capture, chosen before any), every eigh (SVD)
    through the binding's Xsyevd (gesvdj), and agrees with the device form
    without graphs (in the last bits: a host float divides there where a
    device number does here) within rtol 1e-4."""
    from tritd_tpu_torch.ops import decomp, device_linalg, toolbox_loop

    method, svt_method = case.split()[0], case.split()[-1]
    if method == "hooi":
        x = torch.from_numpy(np.random.default_rng(4).random((12, 10, 14))).float().to(cuda_device)

        def call():
            res = decomp.tucker_hooi(x, (3, 4, 5), max_iters=4, tol=0.0)
            return res["core"], res["fit"]
    else:
        spec = DatasetSpec("tiny", "traffic", "T", (24, 20, 32), fctn_subdim=4, sofia_period=4)
        x = torch.from_numpy(synthetic_traffic(spec, np.random.default_rng(1))).float().to(cuda_device)
        mask = torch.from_numpy(np.random.default_rng(2).random(spec.shape) > 0.1).to(cuda_device)
        y = torch.where(mask, x, torch.zeros_like(x))

        def call():
            out = run_method(method, y, x, mask, spec, torch.Generator().manual_seed(0), 10, svt_method=svt_method)
            return out[0], torch.as_tensor(out[2])

    def lowered():
        monkeypatch.setattr(device_linalg, "XSYEV_BATCHED_MAX_N", 8)
        monkeypatch.setattr(device_linalg, "SVD_JACOBI_MAX_K", 8)
        monkeypatch.setattr(svt_ops, "WARM_MIN_DIM", 8)

    lowered()
    with toolbox_loop.forced_route(False):
        plain = call()
    hopper_kernels.reset_launch_counts()
    with _watch(monkeypatch) as seen:
        lowered()
        eager = call()
    driver = "gesvdj" if svt_method == "svd" else "xsyevd"
    assert seen["graphs"] == 0 and hopper_kernels.LINALG_CALLS[f"{driver}[f32]"] > 0
    for e, p in zip(eager, plain):
        assert torch.isfinite(e).all()
        torch.testing.assert_close(e.cpu(), p.cpu(), rtol=1e-4, atol=1e-4 * float(p.abs().max()))


@pytest.mark.cuda
def test_trpca_snn_graph_route_is_the_device_form(cuda_device, monkeypatch):
    """trpca_snn on the card (f32, 12 x 10 x 16, 12 iterations): one
    capture, its SVDs the Jacobi SVD (no gesvdj), bitwise the device form
    without graphs."""
    from tritd_tpu_torch.baselines import trpca
    from tritd_tpu_torch.ops import toolbox_loop

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((12, 10, 16))).float().to(cuda_device)

    def call():
        return trpca.trpca_snn(x, alpha=(1.0, 0.8, 1.2), mu=1e-3, max_iter=12)

    with toolbox_loop.forced_route(False):
        plain = call()
    hopper_kernels.reset_launch_counts()
    with _watch(monkeypatch) as seen:
        graph = call()
    assert seen["graphs"] == 1
    assert hopper_kernels.JACOBI_SVD_LAUNCHES["jacobi_svd[f32]"] > 0 and not any(hopper_kernels.LINALG_CALLS.values())
    assert torch.isfinite(graph[2]).all() and graph[0].is_cuda
    for g, p in zip(graph, plain):
        assert torch.equal(g, p)


@pytest.mark.cuda
def test_tucker_hooi_graph_route_is_the_device_form(cuda_device, monkeypatch):
    """tucker_hooi on the card: one capture, the stop flag read after each
    iteration short of max_iters and the counter at the end, bitwise the
    device form without graphs and the host loop of the same call."""
    from tritd_tpu_torch.ops import decomp, toolbox_loop

    x = torch.from_numpy(np.random.default_rng(4).random((30, 40, 50))).float().to(cuda_device)
    decomp.tucker_hooi(x, (3, 4, 5), max_iters=2, tol=0.0)  # the libraries' set-up outside the watch
    with _watch(monkeypatch) as seen:
        graph = decomp.tucker_hooi(x, (3, 4, 5), max_iters=6, tol=0.0)
    assert seen["graphs"] == 1 and seen["syncs"] == 6 and graph["n_iters"] == 6
    for route in (False, None):
        with toolbox_loop.forced_route(route):
            other = decomp.tucker_hooi(x, (3, 4, 5), max_iters=6, tol=0.0)
        assert torch.equal(other["core"], graph["core"]) and torch.equal(other["fit"], graph["fit"])
        assert all(torch.equal(a, b) for a, b in zip(other["factors"], graph["factors"]))
