"""PyTorch port, multi-process tier: the worker CLI of
tritd_tpu_torch.parallel.distributed run as 2 and 4 gloo/CPU processes, as
tests/test_distributed.py runs the reference's worker, checked against the
port's single-device solver in this process; the collective audit against
the design budget; the scaling probe's rows.

Tolerance: rtol 2e-3, atol 1e-5 on err_hist/rre_hist at float32, the
reference's own (tests/test_distributed.py:76-81): sharding changes the
order of sums."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tritd_tpu_torch.parallel.distributed import (  # noqa: E402
    batch_init,
    build_problem,
    initialize_distributed,
    launch_local,
    main,
    make_host_chip_mesh,
    rank_device,
)
from tritd_tpu_torch.ops.hopper_kernels import KERNEL_VARIANTS  # noqa: E402
from tritd_tpu_torch.solvers import tritd_admm  # noqa: E402
from tritd_tpu_torch.tools import bench_scaling  # noqa: E402

SPAWN_TIMEOUT_S = 300.0


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """The tensors here are tiny: one intra-op thread, here and in the
    workers, keeps the test workers from oversubscribing the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worker_run(tmp_path, world, *args):
    out = tmp_path / "rank0.npz"
    launch_local(world, ["--device", "cpu", "--out", str(out), *args], timeout_s=SPAWN_TIMEOUT_S)
    with np.load(out) as f:
        return dict(f)


@pytest.mark.parametrize("world, max_iter, mode", [(2, 25, 1), (4, 15, 1), (4, 15, 3)],
                         ids=["two_process", "four_process", "four_process_mode3"])
def test_worker_processes_match_single_device(tmp_path, world, max_iter, mode):
    got = _worker_run(tmp_path, world, "--max-iter", str(max_iter), "--shard-mode", str(mode))
    assert int(got["world_size"]) == world and str(got["backend"]) == "gloo" and str(got["device"]) == "cpu"
    # one column per kernel variant; CPU ranks launch no kernel
    assert got["launches"].shape == (world, len(KERNEL_VARIANTS)) and not got["launches"].any()
    assert float(got["replica_max_diff"]) == 0.0
    prob = build_problem(max_iter=max_iter)
    ref = tritd_admm(torch.from_numpy(prob["d"]), prob["cfg"], origin=torch.from_numpy(prob["origin"]))
    assert int(got["n_iters"]) == ref.n_iters == max_iter
    np.testing.assert_allclose(got["err_hist"], ref.err_hist.numpy(), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got["rre_hist"], ref.rre_hist.numpy(), rtol=2e-3, atol=1e-5)
    # the collective audit (bench_scaling.py:205-208): r^4 + the two reduced
    # right-hand sides + the residual sums and the RRE numerator
    n1, n2, n3 = prob["d"].shape
    words = 16 + 4 * ((n2 + n3) if mode == 1 else (n1 + n2)) + 3
    assert int(got["all_reduce_words_per_iter"]) == words and int(got["all_reduce_calls_per_iter"]) == 4
    if mode == 1:
        assert words <= bench_scaling.collective_budget_words(prob["d"].shape, 2)
    assert int(got["all_reduce_bytes_per_iter"]) == 4 * words and int(got["all_reduce_setup_words"]) == 2


def test_worker_batch_masked_bf16_on_a_2x2_mesh(tmp_path):
    got = _worker_run(tmp_path, 4, "--n-data", "2", "--batch", "2", "--masked", "--storage-dtype", "bfloat16",
                      "--max-iter", "12")
    prob = build_problem(max_iter=12, masked=True, storage_dtype="bfloat16", batch=2)
    assert prob["cfg"].masked and prob["d"].shape == (2, 22, 13, 17) and not prob["mask"].all()
    inits = batch_init(2, prob["d"].shape[1:], 2, torch.float32)
    for i in range(2):
        ref = tritd_admm(torch.from_numpy(prob["d"][i]), prob["cfg"], mask=torch.from_numpy(prob["mask"][i]),
                         origin=torch.from_numpy(prob["origin"][i]), init=inits[i])
        assert int(got["n_iters"][i]) == ref.n_iters
        np.testing.assert_allclose(got["err_hist"][i], ref.err_hist.numpy(), rtol=2e-2, atol=1e-4)
        np.testing.assert_allclose(got["rre_hist"][i], ref.rre_hist.numpy(), rtol=2e-2, atol=1e-4)


def test_worker_defaults_to_cuda_and_nccl_and_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--rank", "0", "--world-size", "1"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        rank_device("cuda:0", 0)
    assert rank_device("cpu", 3) == torch.device("cpu")


def test_build_problem_is_seeded_and_follows_the_presets():
    a, b = build_problem(seed=3), build_problem(seed=3)
    np.testing.assert_array_equal(a["d"], b["d"])
    assert a["mask"] is None and a["cfg"].tol == 0.0 and a["d"].shape == (22, 13, 17)
    assert not np.array_equal(a["d"], build_problem(seed=4)["d"])
    taxi = build_problem("sensor", max_iter=7)
    assert taxi["cfg"].max_iter == 7 and taxi["cfg"].mu == 1e-3 and taxi["cfg"].tol == 0.0 and taxi["mask"] is None
    assert (taxi["d"] == 0).mean() >= 0.1 and taxi["origin"].shape == taxi["d"].shape
    with pytest.raises(ValueError, match="fully observed"):
        build_problem("highway", masked=True)


def test_initialize_and_host_chip_mesh_in_one_process(tmp_path, monkeypatch):
    import torch.distributed as dist

    rank, world = initialize_distributed(f"file://{tmp_path}/store", world_size=1, rank=0, device="cpu", timeout_s=60)
    try:
        assert (rank, world) == (0, 1) and dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            make_host_chip_mesh(device_type="cpu")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        mesh = make_host_chip_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "slab") and tuple(mesh.mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_bench_scaling_rows_and_audit(capsys):
    rows = bench_scaling.main(["--device", "cpu", "--counts", "1,2", "--shape", "22,13,17", "--rank-r", "2",
                               "--max-iter", "8", "--repeats", "1", "--timeout-s", str(SPAWN_TIMEOUT_S)])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert printed == rows and [r.get("n_shards") for r in rows] == [1, 2, 2]
    assert rows[0]["efficiency_vs_1"] == 1.0 and rows[1]["iters_per_s"] > 0 and rows[1]["backend"] == "gloo"
    audit = rows[-1]
    assert audit["words_per_iteration"] == 16 + 4 * 30 + 3 and audit["design_budget_words"] == 160
    assert audit["within_budget"] and audit["calls_per_iteration"] == 4
    assert bench_scaling.collective_budget_words((100, 100, 500), 5) == 16258
