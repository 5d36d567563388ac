"""Which eigh and SVD drivers a CUDA graph can capture, at the SVT
baselines' sizes: the probe behind `ops/device_linalg.py`'s choice of
driver.

Two parts. First the binding itself (`eigh` at each n in f32 and f64, `svd`
in f32: its gesvdj row and the hand-written Jacobi SVD's, `jacobi`, which
`device_linalg` takes at these shapes), each size in the driver
`device_linalg` takes there, one JSON line a size: the driver, the device and host workspace bytes its `*_bufferSize`
asks for (a host workspace means host work inside the call), whether a
`torch.cuda.CUDAGraph` capture of the call succeeds (the error text if
not), whether a replay gives the eager call's bits (twice), the eager and
replay µs (CUDA events around `--reps` calls), the µs of
`torch.linalg.eigh` / `svd` on the same matrix and whether the binding
gives its bits, the largest |Δλ| (|Δs|) / ||A|| against torch's result and
both reconstruction errors ||V diag(w) V^T - A|| / ||A||; for the Jacobi
SVD also the sweeps it ran, one replay's device time by kernel (a
torch.profiler trace) and the replay µs and sweeps of a matrix whose
columns are already orthogonal (U S of the first call: few sweeps rotate,
the other sweeps' launches return at once, so the cost of the sweeps
after convergence). Then captures of
`torch.linalg.qr` at the randomized route's sizes (bitwise replays), of
`torch.linalg.eigh` and `svd` themselves (the error text), and which
libcusolver file serves the binding (`dladdr`) beside the cuSOLVER files
`/proc/self/maps` lists. Each group runs in a worker process of its own; a
capture that fails leaves the cuSOLVER handle unfit and fails the next
call, so the worker makes a new handle and spends one call before the next
size.

Second, every cuSOLVER driver at every size, without torch:
`tools/capture_probe.cu`, compiled with nvcc against the libcusolver torch
loads, one process a driver and size (eager µs, workspace bytes, the
capture's statuses, replay bits and µs): Xsyevd, syevj, XsyevBatched (a
batch of one) and Xsyevdx; sytrd and sytrd + orgtr; gesvdj, Xgesvd,
gesvdaStridedBatched and Xgesvdp. Needs a CUDA device and nvcc.

    python -m tritd_tpu_torch.tools.capture_linalg [--reps 10] [--out results/capture_linalg.jsonl]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

EIGH_SIZES = (100, 300, 500, 512, 1000)
SVD_SHAPES = ((100, 50000), (10000, 500), (5000, 1000))
QR_SHAPES = ((4800, 512), (3600, 512))
GROUPS = ("eigh:f32", "eigh:f64", "svd:f32", "torch")
# (driver, dtype code, m, n) of capture_probe.cu (XsyevBatched's m: its batch)
PROBE_CASES = tuple((d, t, 1 if d == "xsyevbatched" else n, n) for d in ("xsyevd", "syevj", "xsyevbatched", "xsyevdx")
                    for t in (0, 1) for n in EIGH_SIZES) + \
    tuple((d, t, n, n) for d in ("sytrd", "sytrd_orgtr") for t in (0, 1) for n in (100, 500, 1000)) + \
    tuple((d, 0, max(m, n), min(m, n)) for d in ("gesvdj", "xgesvd", "gesvda", "xgesvdp") for m, n in SVD_SHAPES)


def _events_us(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _capture(fn):
    """(graph, its outputs, None) or (None, None, error text): fn captured on
    a side stream after one eager call there."""
    import torch

    from tritd_tpu_torch.ops import hopper_kernels

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    out: list = []
    try:
        with torch.cuda.stream(side):
            fn()
            side.synchronize()
            graph = hopper_kernels.CountedGraph(lambda: out.append(fn()), torch.cuda.graph_pool_handle())
    except Exception as err:  # the text is the finding
        torch.cuda.synchronize()
        return None, None, f"{type(err).__name__}: {str(err).splitlines()[0][:300]}"
    torch.cuda.current_stream().wait_stream(side)
    return graph, out[0], None


def _rel(x, norm) -> float:
    return float(x) / float(norm)


def _linalg_case(op: str, shape, dtype, reps: int) -> dict:
    """The binding at one size, in the driver it takes there: eager, against
    torch.linalg, then captured."""
    import torch

    from tritd_tpu_torch.ops import device_linalg

    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    if op == "eigh":
        (n,) = shape
        m = torch.randn((n, 2 * n), generator=gen, device="cuda", dtype=dtype)
        a = m @ m.T
        driver, key = device_linalg.eigh_driver(n, dtype), n
        call = lambda: device_linalg.eigh_with_info(a)  # noqa: E731
        torch_call = lambda: torch.linalg.eigh(a)  # noqa: E731
    else:
        a = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        if op == "jacobi":  # the hand-written Jacobi SVD; its last output the sweeps it ran
            driver, key = "jacobi", None
            call = lambda: device_linalg.jacobi_svd_with_sweeps(a)  # noqa: E731
        else:
            driver, key = "gesvdj", tuple(shape)
            call = lambda: device_linalg.svd_with_info(a)  # noqa: E731
        torch_call = lambda: torch.linalg.svd(a, full_matrices=False)  # noqa: E731
    row = {"op": op, "driver": driver, "shape": list(a.shape), "dtype": str(dtype).removeprefix("torch.")}
    eager = call()
    torch.cuda.synchronize()
    if op == "jacobi":
        row["sweeps"] = int(eager[-1])
    else:
        sizes = device_linalg._device(a.device).sizes[(driver, dtype, key)]
        if isinstance(sizes, tuple):
            row["device_workspace_bytes"], row["host_workspace_bytes"] = sizes
        else:
            row["device_workspace_bytes"], row["host_workspace_bytes"] = sizes * a.element_size(), 0
        row["info"] = int(eager[-1])
    want = torch_call()
    row["bitwise_torch"] = _same(eager[:-1], want)
    norm = torch.linalg.matrix_norm(a)
    if op == "eigh":
        w, v = eager[0], eager[1]
        row["finite"] = bool(torch.isfinite(w).all() and torch.isfinite(v).all())
        row["max_dlambda_rel"] = _rel((w - want[0]).abs().max(), norm)
        row["recon_rel"] = _rel(torch.linalg.matrix_norm((v * w) @ v.T - a), norm)
        row["torch_recon_rel"] = _rel(torch.linalg.matrix_norm((want[1] * want[0]) @ want[1].T - a), norm)
    else:  # svd, jacobi
        u, s, vh = eager[:3]
        row["finite"] = bool(torch.isfinite(s).all() and torch.isfinite(u).all() and torch.isfinite(vh).all())
        row["max_ds_rel"] = _rel((s - want[1]).abs().max(), norm)
        row["recon_rel"] = _rel(torch.linalg.matrix_norm((u * s) @ vh - a), norm)
        row["torch_recon_rel"] = _rel(torch.linalg.matrix_norm((want[0] * want[1]) @ want[2] - a), norm)
    row["eager_us"] = _events_us(call, reps)
    row["torch_us"] = _events_us(torch_call, reps)
    graph, captured, err = _capture(call)
    row["captures"] = graph is not None
    if err:
        row["capture_error"] = err
        # the failed capture leaves the handle unfit, and the next call reports it once
        device_linalg._DEVICES.clear()
        with contextlib.suppress(RuntimeError):
            call()
            torch.cuda.synchronize()
        return row
    for key in ("replay_bitwise", "replay_again_bitwise"):
        graph.replay()
        torch.cuda.synchronize()
        row[key] = _same(captured[:-1], eager[:-1])
    row["replay_us"] = _events_us(graph.replay, reps)
    if op == "jacobi":
        row["kernels"] = _by_kernel(graph)
        u, s, vh = eager[:3]
        done = ((u * s) if a.shape[0] >= a.shape[1] else (s[:, None] * vh)).contiguous()
        floor, out, _err = _capture(lambda: device_linalg.jacobi_svd_with_sweeps(done))
        floor.replay()
        torch.cuda.synchronize()
        row["converged_input_sweeps"] = int(out[-1])
        row["converged_input_replay_us"] = _events_us(floor.replay, reps)
    return row


def _by_kernel(graph) -> list[dict]:
    """One replay of `graph` by kernel, from a torch.profiler trace of the
    card: calls, device ms and µs a call, the longest first."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        ms = (getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)) / 1e3
        if e.count:  # "void (anonymous namespace)::rotate_kernel<float>(...)" -> rotate_kernel
            found = re.search(r"(\w+)(?:<[^>]*>)?\(", e.key.split("::")[-1])
            rows.append({"kernel": found.group(1) if found else e.key[:60], "calls": e.count, "ms": ms,
                         "us_a_call": ms * 1e3 / e.count})
    return sorted(rows, key=lambda r: -r["ms"])


def _torch_cases(reps: int) -> list[dict]:
    """Captures of torch.linalg itself: qr at the randomized route's sizes,
    then eigh and svd (expected to fail: they read `info` to the host)."""
    import torch

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in QR_SHAPES:
        y = torch.randn(shape, generator=gen, device="cuda")
        fn = lambda: torch.linalg.qr(y)  # noqa: E731
        eager = fn()
        torch.cuda.synchronize()
        row = {"op": "torch.linalg.qr", "shape": list(shape), "dtype": "float32", "eager_us": _events_us(fn, reps)}
        graph, captured, err = _capture(fn)
        row["captures"] = graph is not None
        if err:
            row["capture_error"] = err
        else:
            graph.replay()
            torch.cuda.synchronize()
            row["replay_bitwise"] = _same(captured, eager)
            row["replay_us"] = _events_us(graph.replay, reps)
        rows.append(row)
    # last: a capture that fails may leave the process unfit
    m = torch.randn((500, 1000), generator=gen, device="cuda")
    g = m @ m.T
    for name, fn in (("torch.linalg.eigh", lambda: torch.linalg.eigh(g)),
                     ("torch.linalg.svd", lambda: torch.linalg.svd(m, full_matrices=False))):
        graph, _out, err = _capture(fn)
        rows.append({"op": name, "shape": list(g.shape if name.endswith("eigh") else m.shape), "dtype": "float32",
                     "captures": graph is not None, "capture_error": err})
    return rows


def _library_files() -> dict:
    import torch

    from tritd_tpu_torch.ops import device_linalg

    torch.zeros(1, device="cuda")
    device_linalg.eigh_with_info(torch.eye(4, device="cuda"))
    with open("/proc/self/maps") as maps:
        mapped = sorted({line.split()[-1] for line in maps if "cusolver" in line and "/" in line})
    return {"cusolver_version": device_linalg.version(), "serving_file": device_linalg.provider(),
            "mapped_cusolver_files": mapped, "torch": torch.__version__, "torch_cuda": torch.version.cuda}


def _worker(group: str, reps: int) -> None:
    import torch

    print("CASE " + json.dumps({"group": group, **_library_files()}), flush=True)
    if group == "torch":
        for row in _torch_cases(reps):
            print("CASE " + json.dumps(row), flush=True)
        return
    op, tag = group.split(":")
    dtype = {"f32": torch.float32, "f64": torch.float64}[tag]
    for shape in ([(n,) for n in EIGH_SIZES] if op == "eigh" else SVD_SHAPES):
        for case in ("jacobi", "svd") if op == "svd" else (op,):
            try:
                row = _linalg_case(case, shape, dtype, reps)
            except Exception as err:  # one size's failure is a finding, not the end of the group
                torch.cuda.synchronize()
                row = {"op": case, "shape": list(shape), "dtype": str(dtype).removeprefix("torch."),
                       "error": f"{type(err).__name__}: {str(err)[:300]}"}
            print("CASE " + json.dumps(row), flush=True)


def _probe_drivers() -> list[dict]:
    """capture_probe.cu, built with nvcc against the libcusolver torch loads,
    one process a case."""
    import nvidia.cusolver

    from tritd_tpu_torch.runtime import build

    lib = Path(list(nvidia.cusolver.__path__)[0]) / "lib"
    src = Path(__file__).resolve().parent / "capture_probe.cu"
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "capture_probe"
        subprocess.run([build.find_nvcc(), "-O2", "-std=c++17", "-arch=sm_90a", str(src), "-o", str(exe), f"-L{lib}",
                        "-l:libcusolver.so.11", "-Xlinker", f"-rpath={lib}"], check=True, capture_output=True)
        for driver, dt, m, n in PROBE_CASES:
            proc = subprocess.run([str(exe), driver, str(dt), str(m), str(n)], capture_output=True, text=True,
                                  timeout=300)
            rows.append(json.loads(proc.stdout) if proc.returncode == 0 else
                        {"driver": driver, "dt": dt, "m": m, "n": n, "exit": proc.returncode})
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default="results/capture_linalg.jsonl")
    parser.add_argument("--worker", choices=GROUPS, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("capture_linalg needs a CUDA device")
    if args.worker:
        _worker(args.worker, args.reps)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    head = {"card": card, **_library_files(), "build_s": time.perf_counter() - t0}
    print(json.dumps(head), flush=True)
    rows = [head]
    for group in GROUPS:
        proc = subprocess.run([sys.executable, "-m", "tritd_tpu_torch.tools.capture_linalg", "--worker", group,
                               "--reps", str(args.reps)], capture_output=True, text=True, timeout=900)
        got = [json.loads(line[5:]) for line in proc.stdout.splitlines() if line.startswith("CASE ")]
        if proc.returncode:
            got.append({"group": group, "exit": proc.returncode, "stderr": proc.stderr[-2000:]})
        for row in got:
            print(json.dumps(row), flush=True)
        rows += got
    for row in _probe_drivers():
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
