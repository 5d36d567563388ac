"""One run of one benchmark cell of the PyTorch and CUDA port, `tritd_tpu_torch`.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks for.

A cell (`BENCHMARK.json` `workloads`) is a configuration (`configs/<name>.json`:
the protocol's dataset, its shape, presets and the stand-in's generator in
`data/<generator>.py`) under a traffic mix (`traffic/<name>.json`: the solver
the user calls, found as `methods/<method>.py`, its iterations, how many
solves are compared and traced). Its correctness limits are in
`cells/<workload>.json`, and each metric is read by `metrics/<metric>.py`.

Set-up (timed as `setup_s`, from the start of the process): the data, its
masks and whatever else a solve starts from are made on the device from the
configuration's own `data_seed`, so every run solves the same instances as
the protocol solves one dataset, and every seed draws work of one
difficulty; the run's seed orders them; then one warm solve of the cell's
shapes runs. The window is a closed loop of one caller: solve i
starts when solve i - 1 has synchronised, and runs until `--seconds` have
passed. Each solve is timed on the host clock from the call to the
`torch.cuda.synchronize()` after it. With `--trace 1` the profiler records a
fixed number of solves near the window's start (CPU and CUDA activity) and
the run reports the per-layer metrics; with `--trace 0` nothing is traced
and the run reports the end-to-end metrics.

After the window: the peak of device memory is read, the process is
checked for JAX (`jax`, `jaxlib`, `flax`, the JAX package `tritd_tpu`, by
whole top-level module names), and a sample of the window's solves, drawn
from the seed, is held to the plain reference (`reference/`), run in
float64 on the same inputs. The last line of standard output is one JSON
object; the compared numbers and their limits are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tritd_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """Everything one run of `workload` reads, found by the names in the
    manifest."""
    manifest = load_json(root / "BENCHMARK.json")
    (entry,) = [w for w in manifest["workloads"] if w["name"] == workload]
    (config_entry,) = [c for c in manifest["configs"] if c["name"] == entry["config"]]

    def applies(metric: dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    return {"workload": workload, "chips": entry["chips"],
            "config": load_json(root / config_entry["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
            **{key: load_json(BENCH / "cells" / f"{workload}.json").get(key, {})
               for key in ("limits", "instance_limits")},
            "end_to_end": [(m["name"], m["unit"]) for m in manifest["end_to_end"] if applies(m)],
            "per_layer": [(m["name"], m["unit"]) for m in manifest["per_layer"] if applies(m)]}


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (data, inputs, sample, warm-up)."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def make_data(config: dict, seed: int, device) -> dict:
    """The configuration's stand-in (`data/<generator>.py`) and its observed
    tensors, drawn on the device from the configuration's `data_seed`, the
    observed tensors in an order drawn from the run's seed; `instance` holds
    each one's place in the draw, which names it in `instance_limits`."""
    import numpy as np
    import torch

    generator = importlib.import_module(f"benchmark.data.{config['generator']}")
    data = generator.make(config, torch.Generator(device=device).manual_seed(subseed(config["data_seed"], "data")),
                          torch.Generator(device=device).manual_seed(subseed(config["data_seed"], "masks")), device)
    order = np.random.default_rng(subseed(seed, "order")).permutation(len(data["observed"]))
    data["observed"] = [data["observed"][k] for k in order]
    data["instance"] = [int(k) for k in order]
    return data


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float, solve=None) -> dict:
    """One run: set-up, the window, the checks and the metrics. Returns the
    result object. `solve(method, inputs) -> outputs` replaces the timed
    path (the tests' controls and faults); by default it is the method's own."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as trace_mod

    config, traffic = cell["config"], cell["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.zeros((), device=device)  # the allocator's statistics exist once the context does
        torch.cuda.reset_peak_memory_stats(device)

    data = make_data(config, seed, device)
    method = importlib.import_module(f"benchmark.methods.{traffic['method']}").Method(config, traffic, data, device)
    solve = solve or (lambda m, inp: m.solve(inp))
    warm = method.inputs(0, torch.Generator(device=device).manual_seed(subseed(seed, "warm")))
    keep = traffic["sample"]
    # The sample's outputs are copied into slots made here, the last slot
    # taking each solve that is not kept, so that every seed holds the same
    # memory and makes the same Python objects at every solve: which solves
    # the sample keeps then moves neither the peak nor when Python's
    # collector frees what the program leaves to it.
    out = solve(method, warm)
    slots = [{name: torch.empty_like(x) for name, x in out.items()} for _ in range(keep + 1)]
    _sync(torch, device)
    del warm, out
    setup_s = time.perf_counter() - t0

    gen = torch.Generator(device=device).manual_seed(subseed(seed, "inputs"))
    pick = np.random.default_rng(subseed(seed, "sample"))
    first, count = (1, traffic["trace_solves"]) if trace else (None, 0)
    sample, times, prof = [None] * (keep + 1), [], None
    unfinished = torch.zeros((), dtype=torch.int64, device=device)
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds or (trace and i < first + count):
        inp = method.inputs(i, gen)
        traced = trace and first <= i < first + count
        if traced and i == first:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        with record_function(trace_mod.SOLVE_SPAN) if traced else contextlib.nullcontext():
            t = time.perf_counter()
            out = solve(method, inp)
            _sync(torch, device)
            times.append(time.perf_counter() - t)
        if traced and i == first + count - 1:
            prof.stop()
        unfinished += ~method.finite(out)
        j = int(pick.integers(0, i + 1))  # a reservoir sample of the window's solves
        slot = min(i if i < keep else j, keep)
        for name, x in out.items():
            slots[slot][name].copy_(x)
        sample[slot] = (i, inp, slots[slot])
        del out, x
        i += 1
    _sync(torch, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    traced = trace_mod.from_profiler(prof, count, count * traffic["iterations"]) if trace else None
    del prof

    sample = [entry for entry in sample[:keep] if entry is not None]
    checks, limits = {}, {}
    for _i, inp, out in sample:
        ref = method.reference(inp)
        own = cell["instance_limits"].get(str(inp["instance"]), {})
        for name, value in method.compare(out, ref).items():
            key = f"{name}@{inp['instance']}" if name in own else name
            limits[key] = own.get(name, cell["limits"][name])
            checks[key] = max(checks.get(key, 0.0), value) if not math.isnan(value) else math.inf
        del ref
    failed = int(unfinished)
    correct = bool(sample) and failed == 0 and all(value <= limits[key] for key, value in checks.items())

    ctx = types.SimpleNamespace(setup_s=setup_s, solve_s=times, peak_bytes=peak, trace=traced, config=config)
    metrics = {}
    for name, unit in cell["per_layer" if trace else "end_to_end"]:
        value = metric_reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell["chips"], "memory_peak_bytes": peak}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    if device.type == "cuda":
        dev["card"] = _power_limit()
    result = {"correct": correct, "attempted": len(times), "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = traced.breakdown()
    result["checks"] = {key: {"value": value if math.isfinite(value) else str(value), "limit": limits[key]}
                        for key, value in checks.items()}
    result["checks"]["unfinished_solves"] = {"value": failed, "limit": 0}
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__(f"the process holds {', '.join(found)} after the window")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0), _T0)
    except ForbiddenImport as exc:
        print(exc, file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
