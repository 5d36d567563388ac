"""The trace reduction and the per-layer readers, on hand-made records."""

import sys
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import counts, run  # noqa: E402
from benchmark.trace import SOLVE_SPAN, Trace  # noqa: E402

BLOCK = "void elementwise_block_kernel<float, float, float, float>(...)"


def make_trace(device, host=(), solves=1, iterations=10, window=(0.0, 1000.0)):
    spans = [(SOLVE_SPAN, window[0], window[1])] if solves == 1 else list(host)
    return Trace(list(device), spans + [h for h in host if h[0] != SOLVE_SPAN], solves, iterations)


def test_busy_is_the_union_of_overlapping_records_clipped_to_the_window():
    tr = make_trace([("k", 100.0, 300.0), ("k", 200.0, 400.0), ("m", 350.0, 500.0), ("late", 900.0, 1200.0),
                     ("early", -50.0, 10.0)])
    assert tr.busy() == [(0.0, 10.0), (100.0, 500.0), (900.0, 1000.0)]
    assert tr.busy_s == pytest.approx(510e-6)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.gaps() == [(10.0, 100.0), (500.0, 900.0)]


def test_window_needs_every_traced_solve_span():
    with pytest.raises(RuntimeError):
        Trace([("k", 0.0, 1.0)], [(SOLVE_SPAN, 0.0, 2.0)], 2, 20)


def test_breakdown_names_the_innermost_host_record_in_each_gap():
    host = [(SOLVE_SPAN, 0.0, 1000.0), ("cudaGraphLaunch", 20.0, 60.0), ("aten::mm", 520.0, 880.0),
            ("aten::linalg_solve", 600.0, 750.0)]
    tr = Trace([("k", 0.0, 10.0), ("k", 100.0, 500.0), ("m", 900.0, 1000.0)], host, 1, 10)
    got = tr.breakdown()
    assert got["device_ops"][0] == ["k", pytest.approx(410e-6)]
    assert got["idle_gaps"] == [["aten::linalg_solve (1 gaps)", pytest.approx(400e-6)],
                                ["cudaGraphLaunch (1 gaps)", pytest.approx(90e-6)]]


def ctx_of(trace, shape=(100, 100, 500)):
    return types.SimpleNamespace(trace=trace, config={"shape": list(shape), "dtype": "float32"},
                                 setup_s=12.5, solve_s=[0.08, 0.09, 0.1], peak_bytes=3 * 2**20)


def test_idle_kernels_and_mode_solves_readers():
    tr = make_trace([("gemm", 0.0, 400.0), (BLOCK, 400.0, 500.0), ("Memcpy DtoD (Device -> Device)", 500.0, 600.0)])
    ctx = ctx_of(tr)
    assert run.metric_reader("device.idle_pct")(ctx) == pytest.approx(40.0)
    assert run.metric_reader("admm.kernels_per_iter")(ctx) == pytest.approx(0.2)
    assert run.metric_reader("mode_solves.device_ms_per_iter")(ctx) == pytest.approx(0.04)


def test_block_roofline_is_the_byte_bound_over_the_mean_launch():
    bound_us = counts.block_bound_s((100, 100, 500), 40) * 1e6
    tr = make_trace([(BLOCK, 0.0, 2 * bound_us), (BLOCK, 500.0, 500.0 + 2 * bound_us), ("gemm", 0.0, 10.0)])
    assert run.metric_reader("block.roofline_pct")(ctx_of(tr)) == pytest.approx(50.0)
    assert run.metric_reader("block.roofline_pct")(ctx_of(make_trace([("gemm", 0.0, 10.0)]))) is None


def test_svt_roofline_is_the_unfoldings_bound_over_busy_time_an_iteration():
    bound = sum(counts.svd_bound_s(m, n) for m, n in counts.tt_unfoldings((100, 100, 500)))
    tr = make_trace([("jacobi", 0.0, 1000.0)], iterations=10)
    assert run.metric_reader("svt.roofline_pct")(ctx_of(tr)) == pytest.approx(100.0 * bound / 100e-6)


def test_readers_without_a_trace_return_nothing_and_end_to_end_readers_read_the_run():
    ctx = ctx_of(None)
    for name in ("device.idle_pct", "admm.kernels_per_iter", "mode_solves.device_ms_per_iter",
                 "block.roofline_pct", "svt.roofline_pct"):
        assert run.metric_reader(name)(ctx) is None
    assert run.metric_reader("solve_ms")(ctx) == pytest.approx(90.0)
    assert run.metric_reader("peak_mib")(ctx) == pytest.approx(3.0)
    assert run.metric_reader("setup_s")(ctx) == 12.5
