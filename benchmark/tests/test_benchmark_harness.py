"""A whole run of each cell on the CPU at a small size, the card's look
skipped: the timed path as it is comes out correct; the control (the
reference in TF32 put in the program's place) and each fault the cell can
have, planted in the program under the timed path, come out not correct.
The limits are the cells' own (`cells/<workload>.json`)."""

import importlib
import sys
import time
import weakref
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import run  # noqa: E402
from tritd_tpu_torch.baselines import device_loop, ttnn  # noqa: E402
from tritd_tpu_torch.solvers import admm  # noqa: E402

SMALL = {"taxi.triple": ([12, 10, 16], 10), "taxi.ttnn_svd": ([12, 10, 16], 10)}
WORKLOADS = sorted(SMALL)


def small_cell(workload: str) -> dict:
    cell = run.load_cell(workload)
    shape, iters = SMALL[workload]
    cell["config"]["shape"] = shape
    cell["traffic"]["iterations"] = iters
    return cell


def run_small(workload: str, solve=None, trace: bool = False) -> dict:
    return run.run_cell(small_cell(workload), 2**31 + 11, 0.3, trace, torch.device("cpu"), time.perf_counter(),
                        solve=solve)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_timed_path_comes_out_correct(workload):
    res = run_small(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"solve_ms", "setup_s"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_tf32_control_comes_out_not_correct(workload):
    res = run_small(workload, solve=lambda m, inp: m.reference(inp, torch.float32, tf32=True))
    assert not res["correct"], res["checks"]


def _unchanged_admm(d, state, cfg, **kwargs):
    return state


def _unchanged_loop(step, carry, kinds, segments, graphs):
    return carry


def _altered_block(block):
    def altered(*args, **kwargs):
        o, *rest = block(*args, **kwargs)
        o = o.clone()
        o[(0,) * o.dim()] += 100.0  # one entry off by about the data's own scale
        return (o, *rest)
    return altered


def _altered_svt(svt):
    def altered(mat, *args, **kwargs):
        out = svt(mat, *args, **kwargs).clone()
        out[(0,) * out.dim()] += 1.0
        return out
    return altered


FAULTS = {
    "taxi.triple": {"state unchanged": (admm, "run_admm", _unchanged_admm),
                    "answer altered": (admm, "elementwise_block", _altered_block(admm.elementwise_block))},
    "taxi.ttnn_svd": {"state unchanged": (device_loop, "run", _unchanged_loop),
                      "answer altered": (ttnn, "svt_ref_compat", _altered_svt(ttnn.svt_ref_compat))},
}


@pytest.mark.parametrize("workload, fault", [(w, f) for w in WORKLOADS for f in FAULTS[w]])
def test_a_fault_in_the_timed_path_comes_out_not_correct(workload, fault, monkeypatch):
    module, name, replacement = FAULTS[workload][fault]
    monkeypatch.setattr(module, name, replacement)
    res = run_small(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_seed_solves_the_same_instances_in_an_order_of_its_own(workload):
    cell = small_cell(workload)
    cpu = torch.device("cpu")
    runs = [run.make_data(cell["config"], seed, cpu) for seed in (2**31 + 11, 2**31 + 12)]
    assert torch.equal(runs[0]["truth"], runs[1]["truth"])
    firsts = [[float(y.flatten()[:64].sum()) for y in data["observed"]] for data in runs]
    assert sorted(firsts[0]) == sorted(firsts[1]) and firsts[0] != firsts[1]
    methods = [importlib.import_module(f"benchmark.methods.{cell['traffic']['method']}").Method(
        cell["config"], cell["traffic"], data, cpu) for data in runs]
    inputs = [m.inputs(3, torch.Generator().manual_seed(seed)) for m, seed in zip(methods, (1, 2))]
    for i, data in zip((0, 1), runs):
        k = data["instance"].index(inputs[i]["instance"])
        assert data["observed"][k] is inputs[i].get("d", inputs[i].get("y"))
    if "init" in inputs[0]:
        assert all(torch.equal(x, y) for x, y in zip(inputs[0]["init"], inputs[1]["init"]))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_sample_holds_copies_so_no_solve_outlives_the_next(workload):
    """Whichever solves the seed's sample keeps, the harness holds the same
    memory: set-up makes one warm solve, and every solve's outputs are
    released before the next solve starts."""
    calls, alive = [], []

    def solve(m, inp):
        assert all(ref() is None for ref in alive), "a solve's outputs outlived the next solve"
        out = {name: x.clone() for name, x in m.solve(inp).items()}
        calls.append(inp)
        alive[:] = [weakref.ref(x) for x in out.values()]
        return out

    res = run_small(workload, solve=solve)
    assert res["correct"], res["checks"]
    assert len(calls) == res["attempted"] + 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_instance_limit_holds_the_solves_of_its_instance(workload):
    cell = small_cell(workload)
    names = list(cell["limits"])
    cell["instance_limits"] = {str(k): {name: 0.0 for name in names} for k in range(cell["config"]["masks"])}
    res = run.run_cell(cell, 2**31 + 11, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert not res["correct"]
    compared = [key for key in res["checks"] if key != "unfinished_solves"]
    assert compared and all("@" in key and res["checks"][key]["limit"] == 0.0 for key in compared)


def test_a_traced_run_needs_device_records():
    with pytest.raises(RuntimeError, match="no device activity"):
        run_small("taxi.triple", trace=True)
