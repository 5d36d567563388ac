"""Device memory that stays allocated after each graph-route call of a loop.

Every call of a device-form loop on the graph route (`solvers.admm._Stepper`)
runs its blocks on a side stream, the device's one (`admm._side_stream`):
a stream that cuBLAS has run on holds its workspace for the life of the
process, so a new stream a call held more memory with every call. This
tool calls `ops.cp_als` (60x70x80, R = 5, 5 iterations) once without
graphs and then `--calls` times on the graph route, then runs one 256x256
GEMM on each of `--streams` new streams, and prints after each step, as one
JSON line, the MiB that `torch.cuda.memory_allocated()` reads after a
synchronize and a garbage collection: flat over the graph-route calls,
32 MiB more a new stream. Needs a CUDA device.

    python -m tritd_tpu_torch.tools.side_stream_memory [--calls 5] [--streams 4]
"""

from __future__ import annotations

import argparse
import gc
import json


def _allocated_mib() -> float:
    import torch

    torch.cuda.synchronize()
    gc.collect()
    return torch.cuda.memory_allocated() / 2**20


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--streams", type=int, default=4)
    args = parser.parse_args(argv)

    import torch

    from tritd_tpu_torch import ops
    from tritd_tpu_torch.ops import toolbox_loop

    if not torch.cuda.is_available():
        raise SystemExit("side_stream_memory needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((60, 70, 80), generator=gen).cuda()
    init = [torch.rand((s, 5), generator=gen).cuda() for s in x.shape]
    print(json.dumps({"step": "start", "allocated_mib": _allocated_mib()}), flush=True)
    for i, graphs in enumerate([False] + [True] * args.calls):
        with toolbox_loop.forced_route(graphs):
            ops.cp_als(x, 5, max_iters=5, tol=0.0, init_factors=init)
        print(json.dumps({"step": f"cp_als call {i}", "graphs": graphs, "allocated_mib": _allocated_mib()}),
              flush=True)
    a = torch.randn(256, 256, device="cuda")
    for i in range(args.streams):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            b = a @ a
        torch.cuda.current_stream().wait_stream(stream)
        del b
        print(json.dumps({"step": f"GEMM on new stream {i}", "allocated_mib": _allocated_mib()}), flush=True)


if __name__ == "__main__":
    main()
