"""PyTorch port: full-protocol parity with the MATLAB-semantics emulator,
twin for twin with `tests/test_emulator_parity.py`.

`tritd_tpu_torch.tools.emulator_parity` runs here in-process on the CPU in
float64 (torch needs no process-wide x64 switch, so no subprocess): 30
iterations of all five solver protocols on the 9x7x24 completion problem
(`--tiny`) and on the 20x24x24 fully observed video problem
(`--tiny-video`), each whole err_hist held to the port's own copy of the
emulator (`tritd_tpu_torch/oracle/matlab_emulator.py`). The protocol-scale
rows, float64 on the card, are `chip_smoke.py` phase 17."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_toolbox_helpers import one_torch_thread  # noqa: E402
from tritd_tpu_torch.tools import emulator_parity  # noqa: E402

METHODS = {"triple", "ttnn", "ring", "fctn", "sofia"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def _rows(capsys, argv):
    rc = emulator_parity.main(argv)
    out = capsys.readouterr().out
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{") and '"method"' in line]
    return rc, rows, out


def test_tiny_full_protocol_parity_all_methods(capsys):
    rc, rows, out = _rows(capsys, ["--tiny", "--device", "cpu"])
    assert rc == 0, out
    assert {r["method"] for r in rows} == METHODS
    for r in rows:
        assert r["pass"] and r["iters_match"], r
        # float64 against float64 at tiny shape: near machine epsilon, far
        # below the protocol-scale bar
        assert r["max_abs_diff_err_hist"] < 1e-10, r
        assert r["device"] == "cpu" and r["dtype"] == "float64/float64"
        assert r["kernel_launches"] == {}  # the CPU runs the plain version
    triple = next(r for r in rows if r["method"] == "triple")
    assert triple["max_abs_diff_rre_hist"] < 1e-10
    assert '"tiny_all_pass": true' in out


def test_tiny_video_protocol_parity_all_methods(capsys):
    """The video presets (VIDEO_TRITD, ring mu 1e-3, the fctn video split,
    lambda and f, sofia m = 1) on a fully observed video-like tensor."""
    rc, rows, out = _rows(capsys, ["--tiny-video", "--device", "cpu"])
    assert rc == 0, out
    assert {r["method"] for r in rows} == METHODS
    for r in rows:
        assert r["pass"] and r["iters_match"], r
        assert r["max_abs_diff_err_hist"] < 1e-10, r


def test_emulator_triple_matches_golden_conventions():
    """The port's emulator copy keeps the column-major primitives the
    pinned golden fixtures were derived with (`tests/test_golden.py`)."""
    from test_golden import BUILD_F, TRIPLE_PRODUCT, UNFOLD_2
    from tritd_tpu_torch.oracle.matlab_emulator import m_build_f, m_triple_product, m_unfold

    i_, j_, t_ = np.meshgrid(np.arange(2), np.arange(3), np.arange(2), indexing="ij")
    x = 100.0 * i_ + 10.0 * j_ + t_
    np.testing.assert_allclose(m_unfold(x, 2), UNFOLD_2)
    i_, p_, q_ = np.meshgrid(np.arange(2), np.arange(2), np.arange(2), indexing="ij")
    a = (1 + i_ + 2 * p_ + 3 * q_).astype(float)
    q_, j_, s_ = np.meshgrid(np.arange(2), np.arange(2), np.arange(2), indexing="ij")
    b = (1 + 2 * q_ + j_ + 4 * s_).astype(float)
    q_, s_, t_ = np.meshgrid(np.arange(2), np.arange(2), np.arange(2), indexing="ij")
    c = (1 + 3 * q_ + s_ + 2 * t_).astype(float)
    np.testing.assert_allclose(m_build_f(b, c), BUILD_F)
    np.testing.assert_allclose(m_triple_product(a, b, c), TRIPLE_PRODUCT)


def test_rows_with_the_emulators_in_worker_processes_equal_the_rows_in_turn():
    """`run_many`, which runs the emulator sides in spawned processes of one
    numpy thread each beside the port sides (how the card's smoke keeps its
    time), gives the rows `run` gives one after the other."""
    prob = emulator_parity.tiny_problem()
    jobs = [(m, prob, 12) for m in ("triple", "sofia")]
    rows = emulator_parity.run_many(jobs, device="cpu", dtype=torch.float64, workers=2)
    for (m, p, it), row in zip(jobs, rows):
        alone = emulator_parity.run(m, p, it, device="cpu")
        assert row["method"] == m and row["pass"], row
        for key in ("n_iters_port", "n_iters_emulator", "final_err_emulator", "max_abs_diff_err_hist"):
            assert row[key] == alone[key], (key, row[key], alone[key])


def test_one_protocol_row_is_written_under_the_out_dir(tmp_path, capsys, monkeypatch):
    """`--dataset/--method` writes its row as JSON under `--out-dir`; a
    dataset of the port's table at a small depth, on the CPU."""
    rc, rows, out = _rows(capsys, ["--dataset", "network", "--method", "triple", "--max-iter", "3",
                                   "--device", "cpu", "--out-dir", str(tmp_path)])
    assert rc == 0, out
    (row,) = rows
    assert row["shape"] == [23, 23, 2016] and row["n_iters_port"] == 3
    written = json.loads((tmp_path / "network_triple.json").read_text())
    assert written == row


def test_cuda_is_the_default_device_and_its_absence_is_an_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    with pytest.raises(SystemExit, match="--device cpu"):
        emulator_parity.main(["--tiny"])
