"""Where a round of the Jacobi SVD's sweep kernel (`csrc/jacobi_svd.cu`)
spends its time on the card: the kernel built again with
`-DTRITD_JACOBI_TRACE`, in which thread 0 of CTA 0 adds the SM cycles of
each phase of its visits (the Gram with its loads, the cluster barrier, the
cluster's sum, the inner pass, the update of W and of V) and of the grid
barriers and sweep ends, over one call at each taxi unfolding (the taxi
stand-in at 10% missing, as phase 9 cuts it), float32 and float64. One JSON
line a call: the plan, the sweeps, the call's ms by events (the traced
build's), and each phase's cycles and µs a round at the SM clock
`nvidia-smi` reads after the call. CTA 0's view: its barriers' waits are
the other CTAs' work.

    python -m tritd_tpu_torch.tools.jacobi_phases [--shapes 100x50000,10000x500,5000x1000]

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

PHASES = ("gram", "cluster_sync", "sum", "inner", "apply_w", "apply_v", "grid_sync", "sweep_end")


def _traced_library():
    from ..runtime import build, kernels

    out = build.BUILD_DIR / f"jacobi_traced_{build.library_path().stem.rsplit('_', 1)[1]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build.compile_library([build.SRC_DIR / "jacobi_svd.cu"], out, extra_flags=("-DTRITD_JACOBI_TRACE",))
    lib = ctypes.CDLL(str(out))
    kernels._bind_jacobi(lib)
    return lib


def _sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return float(out.split()[0])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", default="100x50000,10000x500,5000x1000")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..data import load_dataset, uniform_missing_mask
    from ..ops import device_linalg
    from ..utils.config import README_MISSING_RATIO

    if not torch.cuda.is_available():
        raise SystemExit("jacobi_phases needs a CUDA device")
    lib = _traced_library()
    device_linalg._jacobi_library = lambda: lib  # every call below goes through the traced build
    device_linalg._active_clusters.cache_clear()
    device_linalg._plan.cache_clear()
    x_np, _spec, _prov = load_dataset("taxi")
    mask = uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO)
    y = torch.as_tensor(np.where(mask, x_np, 0.0), dtype=torch.float32, device="cuda")
    n1, n2, n3 = y.shape
    fctn = y.reshape(n1, n2, n3 // 10, 10).permute(0, 2, 1, 3).reshape(n1 * n3 // 10, n2 * 10)
    mats = {"x".join(map(str, m.shape)): m for m in (y.reshape(n1, -1), y.reshape(-1, n3), fctn)}
    cycles = np.zeros(len(PHASES), dtype=np.uint64)
    for dtype in (torch.float32, torch.float64):
        for name in args.shapes.split(","):
            a = mats[name].to(dtype).contiguous()
            device_linalg.jacobi_svd(a)  # the build and the occupancy queries
            torch.cuda.synchronize()
            lib.tritd_jacobi_phase_cycles(cycles.ctypes.data)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            sweeps = device_linalg.jacobi_svd_with_sweeps(a)[3]
            end.record()
            torch.cuda.synchronize()
            mhz = _sm_clock_mhz()
            lib.tritd_jacobi_phase_cycles(cycles.ctypes.data)
            plan = device_linalg._plan(0, *a.shape, dtype)
            rounds = int(sweeps) * (plan.nb - 1)
            print(json.dumps({"unfolding": name, "dtype": str(dtype)[6:], "plan": plan._asdict(),
                              "sweeps": int(sweeps), "rounds": rounds, "ms": start.elapsed_time(end), "sm_mhz": mhz,
                              "cycles": dict(zip(PHASES, map(int, cycles))),
                              "us_a_round": {p: float(c) / rounds / mhz for p, c in zip(PHASES, cycles)}}), flush=True)


if __name__ == "__main__":
    main()
