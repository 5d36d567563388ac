"""PyTorch port, the video protocol: image metrics (PSNR, SSIM, MSAM) and the
foreground scores held against the JAX package on the same arrays, the
ground-truth and v7.3 .mat ingest, the video stand-in's truth, the video
CLI on a tiny sequence, and the figure grid on its artifacts.

Tolerances: PSNR, SSIM and MSAM rtol 1e-5 — float32 on both sides, the SSIM
filter summed in another order (banded GEMMs here, an XLA convolution
there); the foreground scores and mAP are the same host numpy and must be
equal; relative_change rtol 1e-6 (the JAX side runs in float32 here).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.io  # noqa: E402

from tritd_tpu import data as jdata  # noqa: E402
from tritd_tpu.metrics import foreground as jfg  # noqa: E402
from tritd_tpu.metrics import image as jimage  # noqa: E402
from tritd_tpu.metrics.recon import relative_change as j_relative_change  # noqa: E402
from tritd_tpu_torch.cli import figures, run_video  # noqa: E402
from tritd_tpu_torch.data import DATASETS, load_dataset, load_groundtruth, loaders, save_mat73  # noqa: E402
from tritd_tpu_torch.metrics import foreground, image  # noqa: E402
from tritd_tpu_torch.metrics.recon import relative_change  # noqa: E402
from tritd_tpu_torch.utils import artifacts  # noqa: E402

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed=0, shape=(24, 30, 5)):
    """A smooth [20, 220] video and a noisy reconstruction of it."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(np.cumsum(rng.standard_normal(shape), 0), 1)
    x = 20 + 200 * (x - x.min()) / (x.max() - x.min())
    y = np.clip(x + 6 * rng.standard_normal(shape), 0, 255)
    return x.astype(np.float32), y.astype(np.float32)


def test_psnr_ssim_quality_msam_match_jax():
    x, y = _frames()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    pairs = [
        (image.psnr(tx, ty), jimage.psnr(jx, jy)),
        (image.ssim_frame(tx[:, :, 0], ty[:, :, 0]), jimage.ssim_frame(jx[:, :, 0], jy[:, :, 0])),
        *zip(image.quality(tx, ty), jimage.quality(jx, jy)),
        (image.msam(tx, ty), jimage.msam(jx, jy)),
        *zip(image.msiqa(tx, ty), jimage.msiqa(jx, jy)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert float(image.ssim_frame(tx[:, :, 1], tx[:, :, 1])) == pytest.approx(1.0, rel=1e-6)


def test_ssim_per_frame_matches_jax():
    x, y = _frames(1, (16, 40, 4))
    got = image.ssim_frames(torch.from_numpy(np.moveaxis(x, -1, 0)), torch.from_numpy(np.moveaxis(y, -1, 0)))
    want = [float(jimage.ssim_frame(jnp.asarray(x[:, :, t]), jnp.asarray(y[:, :, t]))) for t in range(4)]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_msam_propagates_zero_fibers_as_nan():
    x = torch.ones(3, 4, 5)
    x[0, 0] = 0.0
    assert torch.isnan(image.msam(x, torch.ones(3, 4, 5)))


def _labels(seed, shape=(20, 22, 6)):
    """|O| magnitudes and CDnet labels (0 / 170 non-ROI / 255 foreground)."""
    rng = np.random.default_rng(seed)
    fg = np.abs(rng.standard_normal(shape)) * 40
    gt = np.where(rng.random(shape) < 0.2, 255.0, 0.0)
    gt[rng.random(shape) < 0.05] = 170.0
    fg[gt == 255] += 40
    gt[:, :, 0] = 0.0  # a one-class frame, which mAP skips
    return fg, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_foreground_scores_and_map_equal_jax(seed):
    fg, gt = _labels(seed)
    assert dataclasses.asdict(foreground.foreground_scores(fg, gt)) == dataclasses.asdict(jfg.foreground_scores(fg, gt))
    for thr in (10.0, 50.0):
        got = dataclasses.asdict(foreground.foreground_scores(fg, gt, thr))
        assert got == dataclasses.asdict(jfg.foreground_scores(fg, gt, thr))
    assert foreground.mean_average_precision(fg, gt) == jfg.mean_average_precision(fg, gt)
    for frame in (fg[:, :, 1], fg[:, :, 1] / 100.0, np.zeros((4, 4))):
        assert foreground.graythresh_matlab_double(frame) == jfg.graythresh_matlab_double(frame)
    labels, scores = (gt[:, :, 2] == 255).ravel(), fg[:, :, 2].ravel()
    assert foreground.average_precision(labels, scores) == jfg.average_precision(labels, scores)


def test_relative_change_matches_jax():
    rng = np.random.default_rng(2)
    new, old = rng.standard_normal((2, 5, 6, 7))
    np.testing.assert_allclose(float(relative_change(torch.from_numpy(new), torch.from_numpy(old))),
                               float(j_relative_change(jnp.asarray(new), jnp.asarray(old))), rtol=1e-6)


def test_load_groundtruth_and_mat73(tmp_path):
    gt = np.where(np.random.default_rng(3).random((6, 7, 4)) < 0.3, 255.0, 0.0)
    assert load_groundtruth("highway", str(tmp_path)) is None
    scipy.io.savemat(tmp_path / "highway_gt.mat", {"groundtruth": gt})
    got = load_groundtruth("highway", str(tmp_path))
    np.testing.assert_array_equal(got, gt)
    np.testing.assert_array_equal(got, jdata.load_groundtruth("highway", str(tmp_path)))
    # v7.3: both packages' writers read back through the port's loader
    video = np.random.default_rng(4).random((5, 6, 7)) * 255
    save_mat73(str(tmp_path / "v73" / "sofa.mat"), {"gray_images": video})
    jdata.save_mat73(str(tmp_path / "j73" / "sofa.mat"), {"gray_images": video})
    for sub in ("v73", "j73"):
        x, _spec, prov = load_dataset("sofa", str(tmp_path / sub))
        assert prov == "mat"
        np.testing.assert_array_equal(x, video)


def test_synthetic_video_truth_is_the_stand_ins_draw():
    spec = loaders.DatasetSpec("tiny", "video", "gray_images", (16, 24, 6))
    observed, bg, fg = loaders.synthetic_video_truth(spec)
    np.testing.assert_array_equal(observed, loaders.synthetic_fallback(spec))
    np.testing.assert_allclose(observed, bg + 80.0 * fg, rtol=1e-6)
    assert fg.dtype == bool and fg.any()


def _tiny_video(tmp_path):
    g = np.abs(np.random.default_rng(5).standard_normal((12, 14, 8))) * 120
    scipy.io.savemat(tmp_path / "highway.mat", {"gray_images": g})
    gt = np.where(g > 150, 255.0, 0.0)
    scipy.io.savemat(tmp_path / "highway_gt.mat", {"groundtruth": gt})
    return g


@pytest.mark.parametrize("method", ["triple", "outlier"])
def test_video_cli_on_cpu(tmp_path, capsys, method):
    _tiny_video(tmp_path)
    out = tmp_path / "results"
    rows = run_video.main(["--datasets", "highway", "--method", method, "--max-iter", "10",
                           "--device", "cpu", "--data-dir", str(tmp_path), "--out-dir", str(out)])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert printed == rows and len(rows) == 1
    row = rows[0]
    assert row["provenance"] == "mat" and row["device"] == "cpu" and row["iters"] == 10
    assert row["timing"] == "first_call" and row["method"] == method
    for key in ("psnr", "ssim", "f1", "pwc", "map", "precision", "recall", "rmse_total", "nrmse_sparse"):
        assert np.isfinite(row[key]), key
    assert row["rmse_missing"] == 0.0
    for what in ("errHist", "Xhat", "O"):
        assert os.path.exists(artifacts.artifact_path(str(out), "highway", method, what))
    with np.load(out / "highway_raw.npz") as f:
        assert f["Y"].shape == (12, 14, 8)
    assert artifacts.load_artifact(str(out), "highway", method, "errHist").shape == (10,)


def test_video_cli_missing_entries_and_refusals(tmp_path):
    _tiny_video(tmp_path)
    common = ["--datasets", "highway", "--device", "cpu", "--data-dir", str(tmp_path),
              "--out-dir", str(tmp_path / "r")]
    row = run_video.main([*common, "--max-iter", "5", "--missing-ratio", "0.2"])[0]
    assert row["rmse_missing"] > 0 and np.isfinite(row["nrmse_missing"])
    with pytest.raises(SystemExit):  # a name the reference does not know
        run_video.main([*common, "--method", "nope", "--max-iter", "1"])
    baseline = run_video.main([*common, "--method", "ttnn", "--max-iter", "2", "--svt-method", "gram"])[0]
    assert baseline["method"] == "ttnn" and baseline["svt_method"] == "gram" and baseline["iters"] == 2
    # 10 iterations is not the published protocol: parity fails whatever the clock
    with pytest.raises(SystemExit):
        run_video.main([*common, "--max-iter", "10", "--verify-parity"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            run_video.main(["--datasets", "highway", "--max-iter", "1"])


def test_figures_on_video_cli_artifacts(tmp_path):
    g = _tiny_video(tmp_path)
    out = tmp_path / "results"
    run_video.main(["--datasets", "highway", "--max-iter", "5", "--device", "cpu",
                    "--data-dir", str(tmp_path), "--out-dir", str(out)])
    png = tmp_path / "grid.png"
    fig = figures.foreground_grid(str(out), datasets=("highway",), methods=("Observed", "gt", "triple", "ttnn"),
                                  frame_ids=(3,), runtimes=np.array([[np.nan, np.nan, 1.5, np.nan]]),
                                  save_path=str(png))
    assert png.exists() and len(fig.axes) == 4
    assert len(fig.axes[0].images) == 1 and len(fig.axes[2].images) == 1 and not fig.axes[3].images
    gray = figures.mat2gray(g)
    assert gray.min() == 0.0 and gray.max() == 1.0
    path = figures.tensor2video(g, str(tmp_path / "clip.avi"))
    assert os.path.exists(path) and path.endswith((".gif", ".npz"))
    assert DATASETS["highway"].kind == "video"
