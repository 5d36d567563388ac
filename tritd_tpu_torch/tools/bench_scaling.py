"""Sharded-solver scaling probe.

Counterpart of the reference's `bench_scaling.py`. Runs the mode-1-slab
sharded TriTD-ADMM as 1, 2 and 4 worker processes of
`tritd_tpu_torch.parallel.distributed` on this host and prints one JSON line
per count:

    {"n_shards": N, "iters_per_s": X, "efficiency_vs_1": Y}

then the collective audit: the `all_reduce` calls, words and bytes of one
iteration, counted where the solver makes them (`SlabCollective`), against
the design budget of 2 r^4 + (n2 + n3) r^2 + 8 words. The reference reads
these from compiled HLO; an eager program has none, so they are counted.
The tool fails if the count passes the budget.

    python -m tritd_tpu_torch.tools.bench_scaling                       # one GPU per rank, NCCL
    python -m tritd_tpu_torch.tools.bench_scaling --device cuda:0 --backend gloo
    python -m tritd_tpu_torch.tools.bench_scaling --device cpu --shape 22,13,17 --rank-r 2

The rate is iterations over the slowest rank's loop time (the slab's
transfer and the result's assembly are outside), best of `--repeats` after a
first run that pays the libraries' set-up. Efficiency is rate(N) / (N x
rate(1)) on `--counts`' first entry. Ranks that share one card
(`--device cuda:0`) or one CPU are time-sliced: their efficiency says how
the work divides and what the collectives cost over shared memory, not what
an interconnect carries.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from ..parallel.distributed import launch_local


def collective_budget_words(shape, rank: int) -> int:
    """Design budget of one mode-1 iteration: GramA (r^4), the mode-2 and
    mode-3 right-hand sides ((n2 + n3) r^2), the residual sums, and room for
    one more r^4 and a few scalars."""
    _n1, n2, n3 = shape
    r2 = rank * rank
    return 2 * r2 * r2 + (n2 + n3) * r2 + 8


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--counts", default="1,2,4", help="shard counts, the first the base of the efficiency")
    p.add_argument("--shape", default="96,96,256")
    p.add_argument("--rank-r", type=int, default=5)
    p.add_argument("--max-iter", type=int, default=30)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda", help="cuda (one GPU per rank), cuda:i (all ranks on one card) or cpu")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    p.add_argument("--timeout-s", type=float, default=600.0, help="limit of each count's run")
    args = p.parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split(","))
    counts = [int(v) for v in args.counts.split(",")]

    rows, base = [], None
    with tempfile.TemporaryDirectory() as tmp:
        for n in counts:
            out = os.path.join(tmp, f"n{n}.npz")
            worker = ["--device", args.device, "--shape", args.shape, "--rank-r", str(args.rank_r),
                      "--max-iter", str(args.max_iter), "--bench-repeats", str(args.repeats), "--out", out]
            if args.backend:
                worker += ["--backend", args.backend]
            logs = launch_local(n, worker, timeout_s=args.timeout_s)
            timed = json.loads([ln for ln in logs[0].splitlines() if ln.startswith("{")][-1])
            base = base or (timed["iters_per_s"], n)
            row = {"n_shards": n, "iters_per_s": timed["iters_per_s"],
                   "efficiency_vs_1": timed["iters_per_s"] * base[1] / (base[0] * n),
                   "backend": timed["backend"], "device": timed["device"]}
            print(json.dumps(row), flush=True)
            rows.append(row)
            with np.load(out) as f:
                audit = {k: int(f[f"all_reduce_{k}_per_iter"]) for k in ("calls", "words", "bytes")}
    budget = collective_budget_words(shape, args.rank_r)
    audit_row = {
        "collective_audit": "all_reduce_per_iteration", "n_shards": counts[-1],
        **{f"{k}_per_iteration": v for k, v in audit.items()},
        "design_budget_words": budget, "within_budget": audit["words"] <= budget,
    }
    print(json.dumps(audit_row), flush=True)
    rows.append(audit_row)
    if not audit_row["within_budget"]:
        raise SystemExit(f"all_reduce words per iteration {audit['words']} pass the budget {budget}")
    return rows


if __name__ == "__main__":
    main()
