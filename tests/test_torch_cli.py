"""PyTorch port, surface: the completion CLI on the CPU, dataset specs and
presets equal to the JAX package's, the data stand-ins and .mat ingest, the
RRE metric, and that the port imports no JAX."""

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
from tritd_tpu.utils import config as jconfig  # noqa: E402
from tritd_tpu_torch.cli import run_completion  # noqa: E402
from tritd_tpu_torch.data import DATASETS, load_dataset, loaders, synthetic  # noqa: E402
from tritd_tpu_torch.metrics.recon import evaluate, rre  # noqa: E402
from tritd_tpu_torch.solvers import TriTDConfig  # noqa: E402
from tritd_tpu_torch.utils import artifacts, config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
