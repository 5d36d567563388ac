"""Can the batched sweep's ridge solves be one batched call inside a CUDA graph?

The batched loop (`solvers.admm.run_admm_batch`) solves each entry's
(r^2, r^2) ridge system one after another (`admm._ridge_per_entry`). This
tool tries the alternatives on the card, each form in a process of its own
(a MAGMA call under capture aborts the process):

  per_entry   what the loop does: `normal_eq.ridge_solve` of each entry
  batched     `torch.func.vmap` of it: torch's batched Cholesky factor and
              solve, under torch's default linalg back end
  cusolver    the same under `torch.backends.cuda.preferred_linalg_library("cusolver")`
  magma       the same under `preferred_linalg_library("magma")`

For each it prints one JSON line: whether the capture succeeded, whether a
replay gives the eager call's bits and the per-entry form's bits, and the
CUDA-event ms of one eager call and one replay.

    python -m tritd_tpu_torch.tools.batched_ridge_capture [--batch 4] [--rank 5] [--rows 320]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

FORMS = ("per_entry", "batched", "cusolver", "magma")


def _problem(batch: int, rank: int, rows: int, dtype):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    m = rank * rank
    x = torch.randn(batch, 4 * m, m, generator=gen, device="cuda", dtype=dtype)
    k = x.transpose(1, 2) @ x / (4 * m)  # SPD Grams
    rhs = torch.randn(batch, rows, m, generator=gen, device="cuda", dtype=dtype)
    return k, rhs


def _one(form: str, batch: int, rank: int, rows: int, dtype_name: str) -> dict:
    import torch

    from ..ops import normal_eq
    from ..solvers.admm import _ridge_per_entry

    dtype = getattr(torch, dtype_name)
    k, rhs = _problem(batch, rank, rows, dtype)
    alpha = 1e-3
    if form in ("cusolver", "magma"):
        torch.backends.cuda.preferred_linalg_library(form)

    def call():
        if form == "per_entry":
            return _ridge_per_entry(k, rhs, alpha, "cholesky")
        return torch.func.vmap(lambda ki, ri: normal_eq.ridge_solve(ki, ri, alpha, "cholesky"))(k, rhs)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = call()  # warms the back end's handles outside the capture
        eager = call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    reference = _ridge_per_entry(k, rhs, alpha, "cholesky")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    out = {"form": form, "batch": batch, "rank": rank, "rows": rows, "dtype": dtype_name,
           "eager_ms": start.elapsed_time(end),
           "eager_is_per_entry_bitwise": bool(torch.equal(eager, reference))}
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            captured = call()
    except Exception as err:  # the capture's own failure is the reading
        out.update(captured=False, error=f"{type(err).__name__}: {err}"[:300])
        return out
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    out.update(captured=True, replay_ms=start.elapsed_time(end),
               replay_is_eager_bitwise=bool(torch.equal(captured, eager)),
               replay_is_per_entry_bitwise=bool(torch.equal(captured, reference)),
               replay_max_abs_diff=float((captured - eager).abs().max()))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--rank", type=int, default=5)
    p.add_argument("--rows", type=int, default=320)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--form", choices=FORMS, help="run one form in this process")
    args = p.parse_args(argv)
    if args.form:
        print(json.dumps(_one(args.form, args.batch, args.rank, args.rows, args.dtype)), flush=True)
        return
    for form in FORMS:
        cmd = [sys.executable, "-m", "tritd_tpu_torch.tools.batched_ridge_capture", "--form", form,
               "--batch", str(args.batch), "--rank", str(args.rank), "--rows", str(args.rows), "--dtype", args.dtype]
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        lines = [line for line in run.stdout.splitlines() if line.startswith("{")]
        if run.returncode or not lines:
            tail = (run.stderr.strip().splitlines() or [""])[-1]
            print(json.dumps({"form": form, "exit_code": run.returncode, "captured": False, "error": tail[:300]}),
                  flush=True)
        else:
            print(lines[-1], flush=True)


if __name__ == "__main__":
    main()
