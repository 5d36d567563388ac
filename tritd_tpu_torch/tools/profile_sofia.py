"""Time of SOFIA's device loops, and of their stages, on the card.

Counterpart of the JAX package's `tools/profile_sofia.py`: `sofia_init`'s
loops and stages at a benchmark shape, after a warm-up, with CUDA events
(host clock and a synchronize on the CPU), on both routes of the loops:
the route the entry points take (on the card the CUDA graph route,
`baselines/sofia.py:_graph_route`) and, under `eager_`, the same device
programs without graphs:

* `epoch_ms`: the epoch loop (`sofia_init`'s device form, tol 0) per epoch,
* `als_iter_ms`: one iteration of the masked smoothed CP-ALS loop (tol 0),
* `frame_ms`: one frame of the stream's scan (`_stream_scan`) over the
  dataset's frames, from seeded factors and Holt-Winters state,
* `busy_share`: the card's kernel time over the epoch loop's wall time
  (a `torch.profiler` trace; not measured on the CPU),
* `mode3_sweep_ms`: the mode-3 step, its systems and its Gauss-Seidel sweep
  (on the card one launch of the `mode3_sweep` kernel), called eagerly,
  and `mode3_sweep_graph_ms` as one replay of a CUDA graph that holds it;
  `mode3_split_ms`, `mode3_split_graph_ms` the same for the step split
  in two, its systems in about thirty torch launches and the
  `gauss_seidel_sweep` kernel (the graph's replay is their card time
  without the host's launches),
* `pinv_rows_ms`: the per-row pinv solve of one mode (`pinv_rows`),
* `grams_3modes_ms`: the masked right-hand sides and Grams of all three
  modes,
* `recon_fit_ms`: the reconstruction and the masked fit.

Data: the port's `load_dataset`, 10% missing from
`numpy.random.default_rng(0)`, float32, SOFIA_PRESET (rank 3) and the
dataset's period; factors uniform from a seeded CPU generator.

Run: python -m tritd_tpu_torch.tools.profile_sofia [--dataset network]
     [--device cuda] [--epochs 20] [--reps 10]
Prints one JSON object (and, on the card, its name and power limit).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..baselines import sofia as S
from ..cli.run_completion import resolve_device
from ..ops import sofia_kernels
from ..data import load_dataset, uniform_missing_mask
from ..utils.config import README_MISSING_RATIO, SOFIA_PRESET


def timed_ms(fn, device, reps: int) -> float:
    """Median ms of `fn()` over `reps` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def graph_ms(fn, device, reps: int) -> float | None:
    """Median ms of one replay of a CUDA graph that holds `fn()`, captured
    after a warm-up call on a side stream; None on the CPU."""
    if device.type != "cuda":
        return None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timed_ms(graph.replay, device, reps)


def busy_share(fn, device) -> float | None:
    """The card's kernel time over the wall time of `fn()` (a profiler trace
    after one untraced call); None on the CPU."""
    if device.type != "cuda":
        return None
    from .profile_device import device_times, event_seconds

    fn()
    wall = event_seconds(fn)
    return sum(device_times(fn, 1).values()) / 1e6 / wall


def _stream_inputs(y, omega, u1, u2, m: int) -> tuple:
    """The stream's inputs over the data's frames: its frames and masks
    (frame axis first), the factors, rings and Holt-Winters state from the
    seeded factors (level 1, trend 0, season 0, smoothing 0.2)."""
    r = u1.shape[1]
    dtype, device = y.dtype, y.device
    return (torch.movedim(y, 2, 0).contiguous(), torch.movedim(omega.to(dtype), 2, 0).contiguous(), u1, u2,
            torch.ones((m, r), dtype=dtype, device=device), torch.ones(r, dtype=dtype, device=device),
            torch.zeros(r, dtype=dtype, device=device), torch.zeros((m, r), dtype=dtype, device=device),
            torch.full((3, r), 0.2, dtype=dtype, device=device), torch.full(y.shape[:2], 0.1, dtype=dtype,
                                                                           device=device))


def profile(dataset: str = "network", device="cuda", epochs: int = 20, reps: int = 10) -> dict:
    device = torch.device(device)
    x_np, spec, provenance = load_dataset(dataset)
    mask_np = uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO)
    omega = torch.as_tensor(mask_np, device=device)
    y = torch.where(omega, torch.as_tensor(x_np, dtype=torch.float32, device=device), 0.0)
    p = SOFIA_PRESET
    r, m = p.rank, spec.sofia_period
    gen = torch.Generator().manual_seed(0)
    u1, u2, u3 = (torch.rand((n, r), generator=gen).to(device) for n in y.shape)
    out = {"dataset": dataset, "provenance": provenance, "shape": list(y.shape), "rank": r, "period": m,
           "device": str(device), "dtype": "float32"}

    graphs = S._graph_route(device, r)
    for prefix, route in (("", graphs), ("eager_", False)):
        def init_run(n, route=route):
            return lambda: S._init_run(y, omega, r, m, p.lambda1, p.lambda2, p.lambda3, None, n, 0.0, 300, None,
                                       (u1, u2, u3), route)

        out[prefix + "epoch_ms"] = timed_ms(init_run(epochs), device, max(1, reps // 5)) / epochs
        als_iters = 10
        out[prefix + "als_iter_ms"] = timed_ms(
            lambda route=route: S._als_loop(y, omega, u1, u2, u3, m, p.lambda1, p.lambda2, als_iters, 0.0,
                                            graphs=route), device, reps) / als_iters
        stream = _stream_inputs(y, omega, u1, u2, m)
        out[prefix + "frame_ms"] = timed_ms(
            lambda route=route: S._stream_scan(*stream, m, p.lambda1, p.lambda2, 0.1, 0.05, True, route), device,
            max(1, reps // 5)) / y.shape[2]
        out[prefix + "busy_share"] = busy_share(init_run(epochs), device)
    out["route"] = "graphs" if graphs else "device form without graphs"

    of = omega.to(y.dtype)
    yt, ot = torch.movedim(y, 2, 0), torch.movedim(of, 2, 0)
    rhs_base, gram_base = S._masked_row_systems(yt, ot, S._khatri_rao(u1, u2))
    rhs_base, gram_base = rhs_base.contiguous(), gram_base.contiguous()

    def mode3():
        S._mode3_gauss_seidel(u3, rhs_base, gram_base, p.lambda1, p.lambda2, m)

    def mode3_split():
        sofia_kernels.gauss_seidel_sweep(*S._mode3_systems(u3, rhs_base, gram_base, p.lambda1, p.lambda2, m),
                                         p.lambda1, p.lambda2, m)

    out["mode3_sweep_ms"] = timed_ms(mode3, device, reps)
    out["mode3_sweep_graph_ms"] = graph_ms(mode3, device, reps)
    out["mode3_split_ms"] = timed_ms(mode3_split, device, reps)
    out["mode3_split_graph_ms"] = graph_ms(mode3_split, device, reps)
    rhs1, gram1 = S._masked_row_systems(y, of, S._khatri_rao(u2, u3))
    out["pinv_rows_ms"] = timed_ms(lambda: S._pinv_rows(rhs1, gram1), device, reps)

    def grams():
        S._masked_row_systems(y, of, S._khatri_rao(u2, u3))
        S._masked_row_systems(y.transpose(0, 1), of.transpose(0, 1), S._khatri_rao(u1, u3))
        S._masked_row_systems(yt, ot, S._khatri_rao(u1, u2))

    out["grams_3modes_ms"] = timed_ms(grams, device, reps)
    out["recon_fit_ms"] = timed_ms(
        lambda: torch.linalg.vector_norm(of * (y - S._recon(u1, u2, u3))), device, reps)
    out["mode3_rows"] = int(y.shape[2])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="network")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip())
    out = profile(args.dataset, device, args.epochs, args.reps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
