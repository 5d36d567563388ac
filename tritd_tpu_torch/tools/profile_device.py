"""Device time of the hand-written kernel and of the baseline solves, read
from a `torch.profiler` trace of the card.

CUDA events around a wrapper call also time the host work of the call
(allocations, the ctypes launch), which at a small shape is longer than the
kernel itself. The profiler's kernel records hold what the card spent, so
the share of the byte bound a kernel reaches is stated against them.

Two parts, both float32 unless a variant says otherwise, TF32 off:

* every variant of `csrc/elementwise_block*.cu` (82: float32, float64 and
  the narrow dtypes bf16, float16, float8_e4m3fn, float8_e5m2, and the
  other wide dtype beside each compute dtype) at the taxi
  (100x100x500) and video (240x320x300) shapes, and the variants the sharded solves run
  at the slab shapes a rank holds: device microseconds of the block kernel,
  which must be the one kernel a wrapper call launches, beside the variant's
  bytes over the card's memory rate;
* the baselines at the full taxi shape through `run_method` (ttnn, ring and
  fctn by the gram route, fctn by warm:8, sofia): device milliseconds per
  iteration against the unprofiled CUDA-event time per iteration, so the
  share of the time the card is busy, and the kernels that take most of it.

With `--solves`, also `tritd_admm` (triple) at taxi (10% missing,
COMPLETION_TRITD) and highway (VIDEO_TRITD), f32, 100 iterations, tol 0, on
both routes of `solvers/admm.py`: the CUDA graph route that it takes on the
card and the eager loop. For each: CUDA-event ms per iteration of an
unprofiled solve, and from a trace of one more, device ms per iteration,
the busy share and the kernels that take most of it. A trace records each
kernel a graph replay runs, as it records the eager launches.

Needs a CUDA device and exits with an error without one.

Usage: python -m tritd_tpu_torch.tools.profile_device [--iters 8]
       [--reps 20] [--skip-block] [--skip-baselines] [--solves] [--out result.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

from ..cli.run_completion import resolve_device, run_method
from ..data import load_dataset, uniform_missing_mask
from ..ops import hopper_kernels
from ..ops.narrow import narrow_cast

SHAPES = {"taxi": (100, 100, 500), "video": (240, 320, 300)}
# what one rank of a sharded solve holds (`parallel/sharded_admm.py`): taxi
# over 2, 3 (102 rows) and 4 ranks along mode 1, video over 4 along mode 3
SLAB_SHAPES = {"slab2": (50, 100, 500), "slab3": (34, 100, 500), "slab4": (25, 100, 500), "frames4": (240, 320, 75)}
SLAB_VARIANTS = {"f32": tuple(SLAB_SHAPES), "c32_d32_sbf16_tbf16": ("slab2",)}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SCALARS = (0.5, 0.7, 1.8)   # mu_l, mu_o, lam
MU_NEXT = 0.625
BASELINE_RUNS = (("ttnn", "gram"), ("ring", "gram"), ("fctn", "gram"), ("fctn", "warm:8"), ("sofia", "svd"))


def device_times(fn, reps: int, launches: dict | None = None) -> dict[str, float]:
    """Kernel name -> device microseconds per call of `fn`, from a profiler
    trace of `reps` calls after one untraced call. `launches`, if given, is
    filled with kernel name -> launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {ev.key: ev.self_device_time_total / reps
             for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}
    if not times or sum(times.values()) <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    if launches is not None:
        launches.update({ev.key: ev.count / reps for ev in prof.key_averages()
                         if ev.device_type == DeviceType.CUDA})
    return times


def event_seconds(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def block_bytes_per_element(d_dt, cd, s_dt, t_dt) -> int:
    """Each input read once (D, L in the compute dtype, E, Y_L, Y_O) and each
    output written once (four in the storage dtype, T' when built)."""
    size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    return size(d_dt) + size(cd) + 7 * size(s_dt) + (size(t_dt) if t_dt is not None else 0)


def profile_block(reps: int) -> list[dict]:
    """Rows of every variant at its shapes."""
    rows = []
    for (cd, d_dt, s_dt, t_dt), variant in hopper_kernels.KERNEL_VARIANTS.items():
        if d_dt == cd and s_dt != cd:
            t_dt = None  # masked narrow storage carries no T'
        names = ("taxi", "video") if cd == torch.float32 or variant == "f64" else ("taxi",)
        for name in names + SLAB_VARIANTS.get(variant, ()):
            gen = torch.Generator(device="cuda").manual_seed(0)
            shape = SHAPES.get(name) or SLAB_SHAPES[name]
            raw = [torch.randn(shape, generator=gen, device="cuda") * 3 for _ in range(5)]
            args = [narrow_cast(raw[0], d_dt), raw[1].to(cd), *(narrow_cast(x, s_dt) for x in raw[2:])]
            kw = dict(mu_l_next=None if t_dt is None else MU_NEXT, t_dtype=t_dt)
            if hopper_kernels.kernel_variant(*args, t_dtype=t_dt) != variant:
                raise AssertionError(f"{variant}: dtypes route to another variant")
            launches: dict = {}
            times = device_times(lambda: hopper_kernels._block_cuda(*args, *SCALARS, **kw), reps, launches)
            if not times or not all("elementwise_block_kernel" in k for k in times) or max(launches.values()) > 1.0:
                raise RuntimeError(f"{variant}: a wrapper call is not one launch of the block kernel: {launches}")
            # the mean over the launches the trace holds (it can drop one of them)
            block = sum(us / launches[k] for k, us in times.items())
            per = block_bytes_per_element(d_dt, cd, s_dt, t_dt)
            bound = per * args[0].numel() / PEAK_BYTES_PER_S * 1e6
            rows.append({"variant": variant, "shape": name, "bytes_per_element": per, "block_us": block,
                         "launches_per_call": 1, "bound_us": bound, "share_of_bound": bound / block})
            print(f"block {variant:24s} {name:7s} {per:3d} B/elem: kernel {block:7.1f} us (device, the one launch "
                  f"of a call), bound {bound:6.1f} us, {bound / block:.0%} reached", flush=True)
    return rows


def profile_baselines(iters: int) -> list[dict]:
    x_np, spec, _prov = load_dataset("taxi")
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    mask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), x_np.shape, 0.10), device="cuda")
    y = torch.where(mask, x, torch.zeros_like(x))
    rows = []
    for method, svt_method in BASELINE_RUNS:
        def solve():
            return run_method(method, y, x, mask, spec, torch.Generator().manual_seed(0), iters,
                              svt_method=svt_method)

        solve()
        seconds = event_seconds(solve)
        times = device_times(solve, 1)
        busy_ms = sum(times.values()) / 1e3
        top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
        rows.append({"method": method, "svt_method": svt_method, "iters": iters,
                     "ms_per_iter": seconds / iters * 1e3, "device_ms_per_iter": busy_ms / iters,
                     "busy_share": busy_ms / 1e3 / seconds,
                     "top_kernels_ms_per_iter": {k: us / 1e3 / iters for k, us in top}})
        print(f"{method} {svt_method}: {seconds / iters * 1e3:.2f} ms/iter (events), device "
              f"{busy_ms / iters:.2f} ms/iter, busy {busy_ms / 1e3 / seconds:.0%}; top: "
              + "; ".join(f"{k[:60]} {us / 1e3 / iters:.2f} ms" for k, us in top), flush=True)
    return rows


def profile_solves(iters: int = 100) -> list[dict]:
    """Rows of tritd_admm's two routes at taxi and highway (module docstring)."""
    from ..solvers import init_factors, init_state, run_admm
    from ..utils.config import COMPLETION_TRITD, README_MISSING_RATIO, VIDEO_TRITD

    x_np, _spec, _prov = load_dataset("taxi")
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    mask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO),
                           device="cuda")
    v = torch.as_tensor(load_dataset("highway")[0], dtype=torch.float32, device="cuda")
    rows = []
    for name, d, origin, preset in (("taxi", torch.where(mask, x, torch.zeros_like(x)), x, COMPLETION_TRITD),
                                    ("highway", v, None, VIDEO_TRITD)):
        cfg = dataclasses.replace(preset, max_iter=iters, tol=0.0)
        init = init_factors(torch.Generator().manual_seed(0), tuple(d.shape), cfg.rank, torch.float32)
        norm_d = torch.linalg.vector_norm(d)
        for route in ("graph", "eager"):
            def solve():
                return run_admm(d, init_state(d, cfg, init), cfg, origin=origin, norm_d=norm_d,
                                _eager=route == "eager")

            solve()
            seconds = event_seconds(solve)
            times = device_times(solve, 1)
            busy_ms = sum(times.values()) / 1e3
            top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
            rows.append({"solve": name, "route": route, "iters": iters, "ms_per_iter": seconds / iters * 1e3,
                         "device_ms_per_iter": busy_ms / iters, "busy_share": busy_ms / 1e3 / seconds,
                         "top_kernels_ms_per_iter": {k: us / 1e3 / iters for k, us in top}})
            print(f"triple {name} {route}: {seconds / iters * 1e3:.3f} ms/iter (events), device "
                  f"{busy_ms / iters:.3f} ms/iter, busy {busy_ms / 1e3 / seconds:.0%}; top: "
                  + "; ".join(f"{k[:50]} {us / 1e3 / iters:.3f} ms" for k, us in top), flush=True)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=8, help="iterations of each baseline solve")
    p.add_argument("--reps", type=int, default=20, help="traced calls of each kernel variant")
    p.add_argument("--out", default=None)
    p.add_argument("--skip-baselines", action="store_true", help="leave the baselines out")
    p.add_argument("--skip-block", action="store_true", help="leave the kernel variants out")
    p.add_argument("--solves", action="store_true", help="also tritd_admm's two routes at taxi and highway")
    a = p.parse_args(argv)
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    result = {"card": card, "block": [] if a.skip_block else profile_block(a.reps),
              "baselines": [] if a.skip_baselines else profile_baselines(a.iters),
              "solves": profile_solves() if a.solves else []}
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {a.out}")
    return result


if __name__ == "__main__":
    main()
