"""PyTorch port, utils: the roofline models held to the reference's counts
number for number (the flop and byte models are the algorithm's, whatever
implements it), `annotate` on the card's peaks, and the timing and debug
helpers on the CPU."""

import time

import pytest

torch = pytest.importorskip("torch")

from tritd_tpu.utils import roofline as j_roofline  # noqa: E402
from tritd_tpu_torch.utils import debug, roofline, timing  # noqa: E402

TAXI, VIDEO = (100, 100, 500), (240, 320, 300)


@pytest.mark.parametrize("shape, rank, elem_bytes", [(TAXI, 5, 4), (VIDEO, 5, 4), (TAXI, 5, 2), ((22, 13, 17), 2, 8)])
def test_tritd_model_equals_the_reference(shape, rank, elem_bytes):
    assert roofline.tritd_model(shape, rank, elem_bytes) == j_roofline.tritd_model(shape, rank, elem_bytes)


@pytest.mark.parametrize("svt_method", ["gram", "svd", "warm:8", "warm", "auto:512", "lowrank:64"])
@pytest.mark.parametrize("method", ["ttnn", "ring", "fctn"])
def test_svt_models_equal_the_reference(method, svt_method):
    for shape in (TAXI, VIDEO):
        got = roofline.model_for(method, shape, svt_method)
        assert got == j_roofline.model_for(method, shape, svt_method) and got["flops_per_iter"] > 0


def test_cut_shapes_and_dispatch_equal_the_reference():
    for kind, shape in (("tt", TAXI), ("ring", TAXI), ("fctn", (100, 100, 62, 8))):
        assert roofline._cut_shapes(shape, kind) == j_roofline._cut_shapes(shape, kind)
    assert roofline._svt_cut_cost(100, 50000, "warm:4") == j_roofline._svt_cut_cost(100, 50000, "warm:4")
    assert roofline.model_for("sofia", TAXI, None) is None
    assert roofline.model_for("triple", TAXI, None) == roofline.tritd_model(TAXI, 5)
    assert roofline.model_for("fctn", VIDEO, None, fctn_subdim=4) == j_roofline.model_for("fctn", VIDEO, None, fctn_subdim=4)
    with pytest.raises(ValueError):
        roofline._cut_shapes(TAXI, "star")


def test_annotate_reads_the_cards_peaks():
    """14 tensor passes of 20 MB in 0.43 ms against 3.35 TB/s and 67 TFLOP/s:
    bound by bytes, and a rate above the peak stays a number, never a bound
    of its own."""
    model = roofline.tritd_model(TAXI, 5)
    row = roofline.annotate({"method": "triple"}, model, 0.43e-3, "cuda_events")["roofline"]
    gbps = model["hbm_bytes_per_iter"] / 0.43e-3 / 1e9
    assert row["roofline_bound"] == "hbm" and row["timing_source"] == "cuda_events"
    assert row["achieved_gbps"] == round(gbps, 1) and row["pct_hbm_peak"] == round(100 * gbps / 3350.0, 1)
    assert row["pct_of_bound"] == row["pct_hbm_peak"] < 100
    assert row["pct_flop_peak"] == round(100 * model["flops_per_iter"] / 0.43e-3 / 67e12, 2)
    assert row["arithmetic_intensity"] == round(model["flops_per_iter"] / model["hbm_bytes_per_iter"], 2) < 20
    fast = roofline.annotate({}, model, 1e-5, "cuda_events")["roofline"]
    assert fast["pct_hbm_peak"] > 100 and fast["roofline_bound"] == "hbm"
    dense = {"flops_per_iter": 1e12, "hbm_bytes_per_iter": 1e9}
    assert roofline.annotate({}, dense, 1.0, "walltime/n_iters")["roofline"]["roofline_bound"] == "fp32"
    assert roofline.annotate({}, None, 1.0, "x")["roofline"] is None
    assert roofline.annotate({}, model, None, "x")["roofline"] is None
    assert (roofline.HBM_PEAK_GBPS, roofline.FP32_PEAK_TFLOPS) == (3350.0, 67.0)


def test_phase_timer_accumulates_and_syncs():
    pt = timing.PhaseTimer()
    out = {"x": [torch.ones(3), (torch.zeros(2), 5)]}
    for _ in range(2):
        with pt.phase("solve", tree_to_sync=out):
            time.sleep(0.01)
    with pytest.raises(RuntimeError):
        with pt.phase("broken"):
            raise RuntimeError("x")
    assert pt.counts == {"solve": 2, "broken": 1} and pt.summary()["solve"] >= 0.02
    assert timing.sync(out) is out


def test_device_timer_and_time_fn_on_the_cpu():
    with timing.device_timer() as t:
        time.sleep(0.01)
        running = t()
    assert 0.0 < running <= t() and t() == t()
    calls = []
    best, result = timing.time_fn(lambda a: calls.append(a) or torch.full((2,), float(a)), 3, warmup=2, iters=4)
    assert len(calls) == 6 and best >= 0.0 and result.tolist() == [3.0, 3.0]


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with timing.profiler_trace(str(tmp_path / "prof")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_check_finite_names_the_leaf():
    good = {"a": torch.ones(2), "b": (torch.zeros(1), torch.tensor([1, 2]))}
    debug.check_finite(good)
    bad = [torch.ones(2), {"x": torch.tensor([1.0, float("nan")])}]
    with pytest.raises(FloatingPointError, match="leaf 1 at iteration 3"):
        debug.check_finite(bad, where="iteration 3")
    with pytest.raises(FloatingPointError, match="leaf 0$"):
        debug.check_finite(torch.tensor(float("inf")))


def test_strict_determinism_and_nan_debug_restore_the_settings():
    before = (torch.are_deterministic_algorithms_enabled(), torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32, torch.is_anomaly_enabled())
    with debug.strict_determinism():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with pytest.raises(KeyError):
        with debug.strict_determinism():
            raise KeyError("x")
    with debug.nan_debug():
        assert torch.is_anomaly_enabled()
    assert before == (torch.are_deterministic_algorithms_enabled(), torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32, torch.is_anomaly_enabled())
