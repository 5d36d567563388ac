"""The benchmark's frozen arithmetic reproduces the bounds the port's kernel
tables were stated against (PERF.md, the f32 block and the Jacobi SVD's
taxi unfoldings)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import counts  # noqa: E402


def test_block_bytes_per_element_of_f32_and_narrow_variants():
    assert counts.block_bytes_per_element("float32", "float32", "float32", "float32") == 40
    assert counts.block_bytes_per_element("float64", "float64", "float64", "float64") == 80
    assert counts.block_bytes_per_element("bfloat16", "float32", "bfloat16", "bfloat16") == 22
    assert counts.block_bytes_per_element("float32", "float32", "bfloat16", None) == 22


@pytest.mark.parametrize("shape, bound_us", [((100, 100, 500), 59.7), ((240, 320, 300), 275.1)])
def test_block_bound_at_taxi_and_video(shape, bound_us):
    assert counts.block_bound_s(shape, 40) * 1e6 == pytest.approx(bound_us, abs=0.05)


def test_tt_unfoldings_of_taxi():
    assert counts.tt_unfoldings((100, 100, 500)) == [(100, 50000), (10000, 500)]
    assert counts.tt_unfoldings((240, 320, 300)) == [(240, 96000), (76800, 300)]


@pytest.mark.parametrize("rows, cols, bound_ms", [(100, 50000, 0.0298), (10000, 500, 0.1468), (5000, 1000, 0.2786)])
def test_golub_kahan_bound_of_the_taxi_unfoldings(rows, cols, bound_ms):
    assert counts.svd_bound_s(rows, cols) * 1e3 == pytest.approx(bound_ms, abs=5e-5)
    assert counts.golub_kahan_flops(rows, cols) == counts.golub_kahan_flops(cols, rows)


def test_golub_kahan_counts_the_thin_side_cubed_term():
    assert counts.golub_kahan_flops(3, 3) == pytest.approx(4 * 27 - 4 * 27 / 3)
