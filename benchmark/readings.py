"""The readings that a cell's correctness limits are set from, on the card.

    python3 -m benchmark.readings --workload <name> --seeds 1 2 3 ... [--solves 1] [--out file.jsonl]

For each seed, in one process: the cell's data and inputs as a run of that
seed makes them (the same generator, streams and entry as `run.py`), then
for each of the first `--solves` solves of the window:

* program: the timed path's solve, held to the float64 reference;
* control: the reference put in the program's place in the nearest
  precision below the configuration's float32 with TF32 off, TF32 (operands
  of every matrix product rounded to TF32, `reference/precision.py`);
* f32: the reference in plain float32, as a witness of float32's own spread.

Each line printed is one solve's numbers (`Method.compare`) for each side.
Benchmark runs do not run this; its readings are in PERF.md beside the
limits in `cells/`.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import run


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--solves", type=int, default=1)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the readings are taken on the card; no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = run.load_cell(a.workload)
    config, traffic = cell["config"], cell["traffic"]
    methods = __import__(f"benchmark.methods.{traffic['method']}", fromlist=["Method"])
    out = open(a.out, "a") if a.out else None
    try:
        for seed in a.seeds:
            data = run.make_data(config, seed, device)
            method = methods.Method(config, traffic, data, device)
            gen = torch.Generator(device=device).manual_seed(run.subseed(seed, "inputs"))
            for i in range(a.solves):
                inp = method.inputs(i, gen)
                t = time.perf_counter()
                got = method.solve(inp)
                torch.cuda.synchronize()
                t_solve = time.perf_counter() - t
                ref = method.reference(inp)
                torch.cuda.synchronize()
                t_ref = time.perf_counter() - t - t_solve
                row = {"workload": a.workload, "seed": seed, "solve": i, "instance": inp["instance"],
                       "program": method.compare(got, ref),
                       "control": method.compare(method.reference(inp, torch.float32, tf32=True), ref),
                       "f32": method.compare(method.reference(inp, torch.float32), ref),
                       "solve_s": t_solve, "reference_s": t_ref}
                line = json.dumps(row)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
                del got, ref
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
