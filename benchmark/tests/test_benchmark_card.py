"""On the card, at each cell's own size: the program's first solves of three
seeds come out within the cell's limits, and the control (the reference in
TF32 in the program's place) fails at least one of them on every seed.
Skips where no CUDA device is present."""

import importlib
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import run  # noqa: E402

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their full sizes")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["taxi.triple", "taxi.ttnn_svd"])
def test_program_within_and_control_outside_the_limits(card, workload):
    import torch

    cell = run.load_cell(workload)
    config, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    methods = importlib.import_module(f"benchmark.methods.{traffic['method']}")
    for seed in SEEDS:
        data = run.make_data(config, seed, card)
        method = methods.Method(config, traffic, data, card)
        inp = method.inputs(0, torch.Generator(device=card).manual_seed(run.subseed(seed, "inputs")))
        ref = method.reference(inp)
        got = method.compare(method.solve(inp), ref)
        assert all(got[name] <= limits[name] for name in limits), (seed, got)
        control = method.compare(method.reference(inp, torch.float32, tf32=True), ref)
        assert any(control[name] > limits[name] for name in limits), (seed, control)
