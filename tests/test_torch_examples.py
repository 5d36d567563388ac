"""PyTorch port: the demos and sparse CP-ALS, twin for twin with
`tests/test_examples.py`.

The four demos of `tritd_tpu_torch.examples` run end to end in-process at
their small CPU setting (`--device cpu`) and print the reference demos' JSON
keys; sparse CP-ALS recovers a low-rank tensor from all its entries and
follows dense CP-ALS, here also held to the JAX package's `cp_als_sparse`
on the same numpy float64 inputs and init. `tools.profile_sofia` runs at a
small depth on the CPU."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_toolbox_helpers import close, n, one_torch_thread, x64  # noqa: E402
from tritd_tpu.ops import kruskal as jkruskal  # noqa: E402
from tritd_tpu.ops import sparse as jsparse  # noqa: E402
from tritd_tpu_torch.examples import demo_rc_fctn, demo_rnc_fctn, demo_toolbox, demo_trpca  # noqa: E402
from tritd_tpu_torch.ops import cp_als, cp_als_sparse, ktensor_full, sp_full  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _json_rows(out):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


class TestDemos:
    def test_demo_trpca(self, tmp_path, capsys):
        rc = demo_trpca.main(["--dataset", "highway", "--frames", "6", "--max-iter", "3", "--methods", "tnn",
                              "--out-dir", str(tmp_path), "--device", "cpu"])
        assert rc == 0
        (row,) = _json_rows(capsys.readouterr().out)
        assert {"method", "seconds", "mean_psnr", "final_err"} <= set(row) and row["device"] == "cpu"
        assert np.isfinite(row["mean_psnr"])
        assert (tmp_path / "highway_tnn_errHist.npz").exists()
        assert (tmp_path / "highway_tnn_Xhat.npz").exists()

    def test_demo_rc_fctn(self, tmp_path, capsys):
        rc = demo_rc_fctn.main(["--dataset", "highway", "--frames", "6", "--max-iter", "3",
                                "--out-dir", str(tmp_path), "--cpu"])
        assert rc == 0
        (row,) = _json_rows(capsys.readouterr().out)
        assert {"method", "seconds", "rse", "mean_psnr", "mean_ssim"} <= set(row)
        assert (tmp_path / "highway_fctn_Xhat.npz").exists()

    def test_demo_toolbox(self, capsys):
        rc = demo_toolbox.main(["--n", "10", "--rank", "2", "--device", "cpu"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "cp_als through the class face" in out
        assert "matrix-free" in out
        assert "must decrease: True" in out

    def test_demo_rnc_fctn(self, tmp_path, capsys):
        rc = demo_rnc_fctn.main(["--dataset", "highway", "--frames", "6", "--max-iter", "2",
                                 "--out-dir", str(tmp_path), "--device", "cpu"])
        assert rc == 0
        (row,) = _json_rows(capsys.readouterr().out)
        assert row["method"] == "rnc_fctn" and row["n_iters"] == 2
        assert (tmp_path / "highway_rnc_fctn_errHist.npz").exists()


@pytest.mark.parametrize("demo, has_cpu", [(demo_trpca, True), (demo_rc_fctn, True),
                                           (demo_rnc_fctn, True), (demo_toolbox, False)])
def test_demo_flags_follow_the_reference(demo, has_cpu, capsys):
    """Every demo takes `--device`; only the three whose reference demo has a
    `--cpu` switch take it too (`examples/demo_toolbox.py` has none)."""
    with pytest.raises(SystemExit) as done:
        demo.main(["--help"])
    assert done.value.code == 0
    text = capsys.readouterr().out
    assert "--device" in text and ("--cpu" in text) is has_cpu
    if not has_cpu:
        with pytest.raises(SystemExit) as done:
            demo.main(["--cpu"])
        assert done.value.code == 2


def _all_entries(shape):
    return np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), axis=-1).reshape(-1, len(shape))


class TestSparseCpAls:
    def test_recovers_lowrank_from_nonzero_fibers(self):
        g = np.random.default_rng(5)  # an init ALS leaves its swamp from within 60 sweeps
        shape, r = (10, 11, 12), 2
        fs = [g.random((s, r)) + 0.1 for s in shape]
        dense = ktensor_full([torch.from_numpy(u) for u in fs])
        coords = torch.from_numpy(_all_entries(shape))
        init = [g.random((s, r)) for s in shape]
        res = cp_als_sparse(dense.reshape(-1), coords, shape, rank=r, max_iters=60, tol=1e-9,
                            init_factors=[torch.from_numpy(u) for u in init])
        assert float(res["fit"]) > 0.999
        recon = ktensor_full(res["factors"], res["weights"])
        np.testing.assert_allclose(n(recon), n(dense), rtol=0.05, atol=0.01)
        with x64():
            ref = jsparse.cp_als_sparse(jnp.asarray(n(dense).ravel()), jnp.asarray(_all_entries(shape)), shape,
                                        rank=r, max_iters=60, tol=1e-9, init_factors=[jnp.asarray(u) for u in init])
            close(recon, jkruskal.ktensor_full(ref["factors"], ref["weights"]), 1e-8)
        assert res["n_iters"] == int(ref["n_iters"])

    def test_matches_dense_cp_als_updates(self):
        g = np.random.default_rng(4)
        shape = (8, 9, 10)
        coords_np = np.stack([g.integers(0, s, 200) for s in shape], axis=1)
        vals = torch.from_numpy(g.random(200))
        dense = sp_full(vals, torch.from_numpy(coords_np), shape)
        init = [g.random((s, 3)) for s in shape]
        # every entry as a stored value: the sparse path must treat the
        # duplicates of the draw as accumulated, as the dense tensor does
        res_sp = cp_als_sparse(dense.reshape(-1), torch.from_numpy(_all_entries(shape)), shape, rank=3,
                               max_iters=5, tol=0.0, init_factors=[torch.from_numpy(u) for u in init])
        res_d = cp_als(dense, rank=3, max_iters=5, tol=0.0, init_factors=[torch.from_numpy(u) for u in init])
        np.testing.assert_allclose(float(res_sp["fit"]), float(res_d["fit"]), rtol=1e-10)
        with x64():
            ref = jsparse.cp_als_sparse(jnp.asarray(n(dense).ravel()), jnp.asarray(_all_entries(shape)), shape,
                                        rank=3, max_iters=5, tol=0.0, init_factors=[jnp.asarray(u) for u in init])
            close(res_sp["fit"], ref["fit"], 1e-10)


def test_profile_sofia_times_every_stage_on_the_cpu(capsys):
    from tritd_tpu_torch.tools import profile_sofia

    out = profile_sofia.main(["--dataset", "taxi", "--device", "cpu", "--epochs", "1", "--reps", "1"])
    keys = ("epoch_ms", "als_iter_ms", "mode3_sweep_ms", "mode3_split_ms", "pinv_rows_ms", "grams_3modes_ms",
            "recon_fit_ms")
    assert all(out[k] > 0 for k in keys) and out["shape"] == [100, 100, 500] and out["period"] == 7
    assert out["mode3_sweep_graph_ms"] is None and out["mode3_split_graph_ms"] is None  # no CUDA graph on the CPU
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
