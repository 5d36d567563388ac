"""PyTorch port, surface: the completion CLI on the CPU (with
--verify-parity), the published tables and parity check, dataset specs and
presets equal to the JAX package's, the data stand-ins and .mat ingest, the
RRE metric, the artifact store, and that the port imports no JAX."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.io  # noqa: E402

from tritd_tpu import data as jdata  # noqa: E402
from tritd_tpu.metrics.recon import evaluate as j_evaluate  # noqa: E402
from tritd_tpu.solvers import TriTDConfig as JConfig  # noqa: E402
from tritd_tpu.utils import artifacts as jartifacts  # noqa: E402
from tritd_tpu.utils import config as jconfig  # noqa: E402
from tritd_tpu.utils import published as jpublished  # noqa: E402
from tritd_tpu_torch.cli import run_completion  # noqa: E402
from tritd_tpu_torch.data import DATASETS, load_dataset, loaders, synthetic  # noqa: E402
from tritd_tpu_torch.metrics.recon import evaluate, rre  # noqa: E402
from tritd_tpu_torch.solvers import TriTDConfig  # noqa: E402
from tritd_tpu_torch.utils import artifacts, config, published  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_triple_on_cpu(tmp_path, capsys):
    rows = run_completion.main([
        "--datasets", "sensor", "--methods", "triple", "triple_masked",
        "--missing-ratio", "0.10", "--max-iter", "5", "--device", "cpu",
        "--out-dir", str(tmp_path), "--data-dir", str(tmp_path),
    ])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert printed == rows and [r["method"] for r in rows] == ["triple", "triple_masked"]
    for row in rows:
        assert set(row) == {"dataset", "method", "rre", "seconds", "timing", "iters",
                            "provenance", "device"}
        assert row["dataset"] == "sensor" and row["provenance"] == "synthetic"
        assert row["device"] == "cpu" and row["iters"] == 5
        assert 0.0 < row["rre"] < 1.0
        hist = artifacts.load_artifact(str(tmp_path), "sensor", row["method"], "errHist")
        assert hist.shape == (5,) and np.isfinite(hist).all()
    assert os.path.exists(tmp_path / "sensor_triple_errHist.npz")


def test_cli_refuses_unported_methods(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_completion.main(["--datasets", "sensor", "--methods", "ttnn", "--device", "cpu",
                             "--max-iter", "1", "--out-dir", str(tmp_path)])


def test_cli_cuda_default_fails_loudly_without_cuda():
    if torch.cuda.is_available():
        assert run_completion.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(SystemExit, match="CUDA is not available"):
        run_completion.main(["--datasets", "sensor", "--max-iter", "1"])


def test_config_fields_and_presets_equal_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(TriTDConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert ours == theirs
    for name in ("COMPLETION_TRITD", "VIDEO_TRITD"):
        assert dataclasses.asdict(getattr(config, name)) == dataclasses.asdict(getattr(jconfig, name))
    for name in ("COMPLETION_MISSING_RATIO", "README_MISSING_RATIO", "VIDEO_MISSING_RATIO",
                 "COMPLETION_DATASETS", "VIDEO_DATASETS"):
        assert getattr(config, name) == getattr(jconfig, name)


def test_dataset_specs_equal_jax():
    assert list(DATASETS) == list(jdata.DATASETS)
    for name, spec in DATASETS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jdata.DATASETS[name])


def test_synthetic_stand_ins_follow_the_recipe():
    spec = loaders.DatasetSpec("tiny", "traffic", "T", (6, 5, 30), sofia_period=7)
    x = loaders.synthetic_traffic(spec, np.random.default_rng(0))
    assert x.shape == spec.shape and x.dtype == np.float64 and np.isfinite(x).all()
    obs, bg, fg = synthetic.synthetic_video(np.random.default_rng(1), (16, 24, 10))
    assert obs.shape == bg.shape == fg.shape == (16, 24, 10)
    assert 40.0 <= bg.min() and bg.max() <= 215.0 + 1e-3
    np.testing.assert_allclose(obs, bg + 80.0 * fg, rtol=1e-6)
    lo, _ = synthetic.random_tritd(np.random.default_rng(2), (5, 6, 7), 2)
    np.testing.assert_allclose(np.sqrt(np.mean(lo.astype(np.float64) ** 2)), 1.0, rtol=1e-5)
    spikes = synthetic.sparse_outliers(np.random.default_rng(3), (50, 50), 0.1, 7.0)
    assert set(np.unique(spikes)) <= {-7.0, 0.0, 7.0} and 0.05 < np.mean(spikes != 0) < 0.15


def test_make_completion_problem_follows_the_recipe():
    prob = synthetic.make_completion_problem(np.random.default_rng(0), shape=(6, 7, 8), rank=2,
                                             missing_ratio=0.25, outlier_density=0.1, noise_std=0.01)
    x, y, mask, o = prob["x"], prob["y"], prob["mask"], prob["outliers"]
    assert x.shape == y.shape == mask.shape == o.shape == (6, 7, 8) and y.dtype == np.float32
    assert (~mask).sum() == round(0.25 * mask.size) and (y[~mask] == 0).all()
    assert set(np.unique(o)) <= {-10.0, 0.0, 10.0} and (o != 0).any()
    np.testing.assert_allclose(y[mask], (x + o)[mask], atol=0.1)
    a, b, c = prob["cores"]
    np.testing.assert_allclose(np.sqrt(np.mean(x.astype(np.float64) ** 2)), 1.0, rtol=1e-5)
    assert a.shape == (6, 2, 2) and b.shape == (2, 7, 2) and c.shape == (2, 2, 8)
    clean = synthetic.make_completion_problem(np.random.default_rng(0), shape=(6, 7, 8), rank=2)
    assert not clean["outliers"].any() and (clean["y"][clean["mask"]] == clean["x"][clean["mask"]]).all()


@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.15])
def test_uniform_missing_mask_exact_count(ratio):
    mask = synthetic.uniform_missing_mask(np.random.default_rng(0), (7, 8, 9), ratio)
    assert mask.dtype == bool and (~mask).sum() == round(ratio * mask.size)


def test_mat_ingest_matches_jax_loader(tmp_path):
    rng = np.random.default_rng(0)
    scipy.io.savemat(tmp_path / "taxi.mat", {"T": rng.standard_normal((3, 4, 510))})
    scipy.io.savemat(tmp_path / "sensor.mat", {"other": rng.standard_normal((2, 3, 4))})
    for name, shape in (("taxi", (3, 4, 500)), ("sensor", (2, 3, 4))):
        x, spec, prov = load_dataset(name, str(tmp_path))
        jx, _jspec, jprov = jdata.load_dataset(name, str(tmp_path))
        assert prov == jprov == "mat" and x.shape == shape and spec.name == name
        np.testing.assert_array_equal(x, jx)


def test_evaluate_matches_jax():
    rng = np.random.default_rng(5)
    x_hat, gt = rng.standard_normal((2, 4, 5, 6))
    mask = rng.random((4, 5, 6)) < 0.7
    for m in (None, mask):
        want = j_evaluate(jnp.asarray(x_hat, jnp.float32), jnp.asarray(gt, jnp.float32),
                          None if m is None else jnp.asarray(m))
        got = evaluate(torch.from_numpy(x_hat).float(), torch.from_numpy(gt).float(),
                       None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], rtol=1e-6)
    assert float(rre(torch.ones(3), torch.ones(3))) == 0.0


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tritd_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tritd_tpu_torch.__path__, 'tritd_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tritd_tpu.'))"
        " or m == 'tritd_tpu']\n"
        "assert not bad, bad\n"
        "from tritd_tpu_torch.runtime import kernels\n"
        "assert kernels.library.cache_info().currsize == 0\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def test_published_tables_equal_jax():
    for name in ("PUBLISHED_RRE", "PUBLISHED_SECONDS", "DEFAULT_RRE_GAP"):
        assert getattr(published, name) == getattr(jpublished, name), name


PARITY_ROWS = {
    "ok": {"dataset": "sensor", "method": "triple", "provenance": "mat", "rre": 0.299, "seconds": 1.0},
    "bad_rre": {"dataset": "sensor", "method": "triple_masked", "provenance": "mat", "rre": 0.479},
    "synthetic": {"dataset": "taxi", "method": "triple", "provenance": "synthetic", "rre": 0.34},
    "video_ok": {"dataset": "highway", "method": "triple", "provenance": "mat", "seconds": 5.0},
    "video_slow": {"dataset": "sofa", "method": "fctn", "provenance": "mat", "seconds": 500.0},
    "approx_svt": {"dataset": "office", "method": "ttnn", "provenance": "mat", "seconds": 1.0,
                   "svt_method": "warm:16"},
    "unknown": {"dataset": "sensor", "method": "nope", "provenance": "mat", "rre": 0.1},
    "no_rre": {"dataset": "taxi", "method": "ring", "provenance": "mat"},
}


@pytest.mark.parametrize("kwargs", [
    dict(), dict(gap=0.5), dict(max_iter=10), dict(missing_ratio=0.15),
    dict(max_iter=100, missing_ratio=0.10), dict(missing_ratio=0.0),
])
@pytest.mark.parametrize("rows", [[k] for k in PARITY_ROWS] + [list(PARITY_ROWS), []],
                         ids=[*PARITY_ROWS, "all", "none"])
def test_check_parity_matches_jax(rows, kwargs):
    rows = [dict(PARITY_ROWS[k]) for k in rows]
    assert published.check_parity(rows, **kwargs) == jpublished.check_parity(rows, **kwargs)


def test_cli_verify_parity_fixture_mat(tmp_path):
    """As the reference's test: --verify-parity fails on a fixture .mat
    (real-format provenance, random values), passes it with a generous gap,
    and fails a non-published protocol and a synthetic stand-in whatever
    the gap."""
    t = np.random.default_rng(0).standard_normal((8, 9, 10)) * 10
    scipy.io.savemat(tmp_path / "sensor.mat", {"T": t})
    protocol = ["--max-iter", "100", "--missing-ratio", "0.10", "--device", "cpu"]
    args = ["--datasets", "sensor", "--methods", "triple", *protocol, "--data-dir", str(tmp_path),
            "--out-dir", str(tmp_path / "results"), "--verify-parity"]
    with pytest.raises(SystemExit) as exc:
        run_completion.main(args)
    assert exc.value.code == 1
    rows = run_completion.main(args + ["--parity-gap", "10.0"])
    assert rows and rows[0]["provenance"] == "mat" and rows[0]["timing"] == "first_call"
    with pytest.raises(SystemExit):
        run_completion.main(["--datasets", "sensor", "--methods", "triple", "--max-iter", "5",
                             "--missing-ratio", "0.10", "--device", "cpu", "--data-dir", str(tmp_path),
                             "--out-dir", str(tmp_path / "r3"), "--verify-parity", "--parity-gap", "10.0"])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as exc:
        run_completion.main(["--datasets", "sensor", "--methods", "triple", *protocol,
                             "--data-dir", str(empty), "--out-dir", str(tmp_path / "r2"),
                             "--verify-parity", "--parity-gap", "10.0"])
    assert exc.value.code == 1


def test_cli_verify_parity_re_times_video_rows_warm(tmp_path, capsys):
    """Video rows are judged on wall-clock: with --verify-parity the CLI
    times a second, warm solve and keeps the first call's time beside it."""
    g = np.abs(np.random.default_rng(1).standard_normal((6, 7, 5))) * 100
    scipy.io.savemat(tmp_path / "highway.mat", {"gray_images": g})
    with pytest.raises(SystemExit):  # 3 iterations is not the published protocol
        run_completion.main(["--datasets", "highway", "--max-iter", "3", "--missing-ratio", "0",
                             "--device", "cpu", "--data-dir", str(tmp_path),
                             "--out-dir", str(tmp_path / "r"), "--verify-parity"])
    out = capsys.readouterr().out
    row = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert row["timing"] == "warm" and row["seconds_first_call"] >= 0.0
    assert "PARITY FAIL protocol: max_iter=3" in out


def test_save_raw_same_stem_as_jax(tmp_path):
    y = np.arange(24.0).reshape(2, 3, 4)
    mine = artifacts.save_raw(str(tmp_path / "a"), "highway", y)
    theirs = jartifacts.save_raw(str(tmp_path / "b"), "highway", y)
    assert os.path.basename(mine) == os.path.basename(theirs) == "highway_raw.npz"
    with np.load(mine) as f, np.load(theirs) as g:
        assert f.files == g.files == ["Y"]
        np.testing.assert_array_equal(f["Y"], g["Y"])
