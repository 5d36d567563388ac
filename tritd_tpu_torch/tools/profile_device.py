"""Device time of the hand-written kernel and of the baseline solves, read
from a `torch.profiler` trace of the card.

CUDA events around a wrapper call also time the host work of the call
(allocations, the ctypes launch), which at the taxi shape is as long as the
kernel itself. The profiler's kernel records hold what the card spent, so
the share of the byte bound a kernel reaches is stated against them.

Two parts, both float32 unless a variant says otherwise, TF32 off:

* every variant of `csrc/elementwise_block.cu` at the taxi (100x100x500)
  and video (240x320x300) shapes: device microseconds of the block kernel
  and of its second-pass reduction (a launch of its own), beside the
  variant's bytes over the card's memory rate;
* the baselines at the full taxi shape through `run_method` (ttnn, ring and
  fctn by the gram route, fctn by warm:8, sofia): device milliseconds per
  iteration against the unprofiled CUDA-event time per iteration, so the
  share of the time the card is busy, and the kernels that take most of it.

Needs a CUDA device and exits with an error without one.

Usage: python -m tritd_tpu_torch.tools.profile_device [--iters 8]
       [--reps 20] [--out result.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..cli.run_completion import resolve_device, run_method
from ..data import load_dataset, uniform_missing_mask
from ..ops import hopper_kernels

SHAPES = {"taxi": (100, 100, 500), "video": (240, 320, 300)}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SCALARS = (0.5, 0.7, 1.8)   # mu_l, mu_o, lam
MU_NEXT = 0.625
BASELINE_RUNS = (("ttnn", "gram"), ("ring", "gram"), ("fctn", "gram"), ("fctn", "warm:8"), ("sofia", "svd"))


def device_times(fn, reps: int) -> dict[str, float]:
    """Kernel name -> device microseconds per call of `fn`, from a profiler
    trace of `reps` calls after one untraced call."""
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
    rows = []
    for (cd, d_dt, s_dt, t_dt), variant in hopper_kernels.KERNEL_VARIANTS.items():
        if d_dt == cd and s_dt != cd:
            t_dt = None  # masked narrow storage carries no T'
        for name in ("taxi", "video") if cd == torch.float32 else ("taxi",):
            gen = torch.Generator(device="cuda").manual_seed(0)
            raw = [torch.randn(SHAPES[name], generator=gen, device="cuda") * 3 for _ in range(5)]
            args = [raw[0].to(d_dt), raw[1].to(cd), *(x.to(s_dt) for x in raw[2:])]
            kw = dict(mu_l_next=None if t_dt is None else MU_NEXT, t_dtype=t_dt)
            if hopper_kernels.kernel_variant(*args, t_dtype=t_dt) != variant:
                raise AssertionError(f"{variant}: dtypes route to another variant")
            times = device_times(lambda: hopper_kernels._block_cuda(*args, *SCALARS, **kw), reps)
            block = sum(us for k, us in times.items() if "elementwise_block_kernel" in k)
            final = sum(us for k, us in times.items() if "finalize_kernel" in k)
            if block <= 0.0 or final <= 0.0:
                raise RuntimeError(f"{variant}: the trace names no kernel of the block: {sorted(times)}")
            per = block_bytes_per_element(d_dt, cd, s_dt, t_dt)
            bound = per * args[0].numel() / PEAK_BYTES_PER_S * 1e6
            rows.append({"variant": variant, "shape": name, "bytes_per_element": per, "block_us": block,
                         "finalize_us": final, "bound_us": bound, "share_of_bound": bound / (block + final)})
            print(f"block {variant:24s} {name:5s} {per:3d} B/elem: kernel {block:7.1f} us + second pass "
                  f"{final:5.1f} us (device), bound {bound:6.1f} us, {bound / (block + final):.0%} reached", flush=True)
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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=8, help="iterations of each baseline solve")
    p.add_argument("--reps", type=int, default=20, help="traced calls of each kernel variant")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    result = {"card": card, "block": profile_block(a.reps), "baselines": profile_baselines(a.iters)}
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {a.out}")
    return result


if __name__ == "__main__":
    main()
