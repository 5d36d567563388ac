#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tritd_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run by raising:
  0. require CUDA; turn TF32 off; print the card, its power limit and versions.
  1. build the hand-written kernel (csrc/elementwise_block.cu) with nvcc.
  2. hold the kernel against its plain PyTorch version on the card, float32
     and float64, at the taxi, video, a ragged and a one-element shape, with
     and without T'; time both with CUDA events.
  3. the main path: robust TriTD-ADMM on the taxi completion stand-in
     (100x100x500, r=5, 10% missing, COMPLETION_TRITD, 100 iterations, f32),
     checked against a float64 CPU rerun of its first 10 iterations, and on
     the video stand-in (240x320x300, VIDEO_TRITD, 100 iterations).
  4. the completion CLI in a subprocess.

The line before the last is a JSON object with the kernel's record; the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX or tritd_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import tritd_tpu_torch  # noqa: E402

if Path(tritd_tpu_torch.__file__).resolve().parent.parent != HERE:
    raise SystemExit(f"tritd_tpu_torch must come from {HERE}, got {tritd_tpu_torch.__file__}")

from tritd_tpu_torch.data import load_dataset, uniform_missing_mask  # noqa: E402
from tritd_tpu_torch.metrics.recon import rre  # noqa: E402
from tritd_tpu_torch.ops import hopper_kernels  # noqa: E402
from tritd_tpu_torch.ops.designs import triple_product  # noqa: E402
from tritd_tpu_torch.runtime import build, kernels  # noqa: E402
from tritd_tpu_torch.solvers import init_factors, trim_history, tritd_admm  # noqa: E402
from tritd_tpu_torch.utils.config import COMPLETION_TRITD, README_MISSING_RATIO, VIDEO_TRITD  # noqa: E402

KERNEL_SHAPES = {
    "taxi": (100, 100, 500),
    "video": (240, 320, 300),
    "ragged": (17, 23, 31),
    "one": (1, 1, 1),
}
SCALARS = (0.5, 0.7, 1.8)  # mu_l, mu_o, lam
MU_NEXT = 0.625
REPS = 20
BATCH = 10


def phase0() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase1() -> None:
    t0 = time.perf_counter()
    path = build.build()
    kernels.library()
    print(f"phase1 build: {path.name} in {time.perf_counter() - t0:.2f} s")


def _time_pair(plain, kernel) -> tuple[float, float]:
    """ms per call of each: CUDA events around BATCH back-to-back calls,
    median over REPS turns, alternating which goes first."""
    for _ in range(3):
        plain()
        kernel()
    torch.cuda.synchronize()
    times = {"plain": [], "kernel": []}
    for i in range(REPS):
        order = (("plain", plain), ("kernel", kernel))
        for name, fn in order if i % 2 == 0 else order[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(BATCH):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / BATCH)
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


def phase2() -> dict:
    """Kernel vs plain version on the card. Tensors: rtol 1e-6 with
    atol 1e-6 * max|input| (nvcc contracts a*b+c into one FMA); norms: rtol
    1e-5 (the kernel sums in double, the plain version in the dtype)."""
    main_path = {}
    for seed, (dtype, (name, shape)) in enumerate(
        (dt, item) for dt in (torch.float32, torch.float64) for item in KERNEL_SHAPES.items()
    ):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        args = [torch.randn(shape, generator=gen, dtype=dtype, device="cuda") for _ in range(5)]
        atol = 1e-6 * max(float(a.abs().max()) for a in args)
        for mu_next in (None, MU_NEXT):
            got = hopper_kernels._block_cuda(*args, *SCALARS, mu_l_next=mu_next)
            want = hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next)
            torch.cuda.synchronize()
            idx = (0, 1, 2, 3) if mu_next is None else (0, 1, 2, 3, 6)
            max_abs = max(float((got[i] - want[i]).abs().max()) for i in idx)
            for i in idx:
                torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=atol)
            for i in (4, 5):
                torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
            ms, plain_ms = _time_pair(
                lambda: hopper_kernels._block_torch(*args, *SCALARS, mu_l_next=mu_next),
                lambda: hopper_kernels._block_cuda(*args, *SCALARS, mu_l_next=mu_next),
            )
            n_bytes = (5 + len(idx)) * args[0].numel() * args[0].element_size()
            print(f"phase2 {name:6s} {str(dtype)[6:]:7s} t'={'yes' if mu_next else 'no '} "
                  f"max_abs_err={max_abs:.3e} kernel={ms * 1e3:9.1f} us "
                  f"({n_bytes / ms / 1e6:7.1f} GB/s) plain={plain_ms * 1e3:9.1f} us "
                  f"({n_bytes / plain_ms / 1e6:7.1f} GB/s)")
            if name == "taxi" and dtype == torch.float32 and mu_next is not None:
                main_path = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
    return main_path


def _solve(y, cfg, init, origin=None) -> tuple:
    """One timed solve: CUDA events around it and a final synchronize. A
    3-iteration solve first takes the one-time cuBLAS/cuSOLVER set-up out of
    the timed run; the launch count covers the timed run only."""
    tritd_admm(y, dataclasses.replace(cfg, max_iter=3), origin=origin, init=init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hopper_kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = tritd_admm(y, cfg, origin=origin, init=init)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hopper_kernels.LAUNCHES["elementwise_block"]
    return res, launches, start.elapsed_time(end) / 1e3, wall


def phase3() -> int:
    # taxi completion: the primary row of the reference benchmark
    x_np, _spec, prov = load_dataset("taxi")
    mask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO),
                           device="cuda")
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    y = torch.where(mask, x, torch.zeros_like(x))
    cfg = COMPLETION_TRITD
    init = init_factors(torch.Generator().manual_seed(0), x.shape, cfg.rank, torch.float32)
    res, launches, dev_s, wall = _solve(y, cfg, init, origin=x)
    n = res.n_iters
    err = trim_history(res.err_hist, n)
    if launches != n:
        raise AssertionError(f"taxi: kernel launched {launches} times in {n} iterations")
    if not (np.isfinite(err).all() and err[-1] < err[0]):
        raise AssertionError(f"taxi: err_hist not finite and falling: {err}")
    rre_truth = float(rre(triple_product(res.a, res.b, res.c), x))
    if not (np.isfinite(rre_truth) and rre_truth < 1.0):
        raise AssertionError(f"taxi: RRE vs truth {rre_truth}")
    print(f"phase3 taxi ({prov}) 100x100x500 r=5 f32: iters={n} launches={launches} "
          f"solve={dev_s:.4f} s (events) {wall:.4f} s (wall) {dev_s / n * 1e3:.3f} ms/iter "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB rre={rre_truth:.6f} "
          f"err[0]={err[0]:.4e} err[-1]={err[-1]:.4e}")

    # the first 10 iterations again, float64 on the CPU, from the same init
    cpu = tritd_admm(y.cpu().double(), dataclasses.replace(cfg, dtype="float64", max_iter=10),
                     origin=x.cpu().double(), init=init)
    m = min(cpu.n_iters, n)
    ref = trim_history(cpu.err_hist, m)
    np.testing.assert_allclose(err[:m], ref, rtol=1e-3)
    print(f"phase3 taxi f32 cuda vs f64 cpu, first {m} iterations: "
          f"max rel diff {np.max(np.abs(err[:m] - ref) / np.abs(ref)):.3e} (rtol 1e-3)")

    # video protocol: fully observed
    v_np, _vspec, vprov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    vinit = init_factors(torch.Generator().manual_seed(0), v.shape, VIDEO_TRITD.rank, torch.float32)
    vres, vlaunches, vdev_s, vwall = _solve(v, VIDEO_TRITD, vinit)
    vn = vres.n_iters
    verr = trim_history(vres.err_hist, vn)
    if vlaunches != vn:
        raise AssertionError(f"video: kernel launched {vlaunches} times in {vn} iterations")
    if not (np.isfinite(verr).all() and verr[-1] < verr[0]):
        raise AssertionError(f"video: err_hist not finite and falling: {verr}")
    print(f"phase3 video highway ({vprov}) 240x320x300 r=5 f32: iters={vn} launches={vlaunches} "
          f"solve={vdev_s:.4f} s (events) {vwall:.4f} s (wall) {vdev_s / vn * 1e3:.3f} ms/iter "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"err[0]={verr[0]:.4e} err[-1]={verr[-1]:.4e}")
    return launches


def phase4() -> None:
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "tritd_tpu_torch.cli.run_completion", "--datasets", "taxi",
             "--methods", "triple", "--missing-ratio", "0.10", "--out-dir", out],
            capture_output=True, text=True, cwd=HERE, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"CLI failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        row = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
        if not (row["dataset"] == "taxi" and row["method"] == "triple" and row["device"] == "cuda"
                and 0 < row["iters"] <= 100 and 0.0 < row["rre"] < 1.0):
            raise AssertionError(f"CLI row: {row}")
        with np.load(os.path.join(out, "taxi_triple_errHist.npz")) as f:
            hist = f["errHist"]
        if hist.shape != (row["iters"],) or not np.isfinite(hist).all():
            raise AssertionError(f"CLI artifact: shape {hist.shape}")
        print(f"phase4 cli: {json.dumps(row)}")


def main() -> None:
    device = phase0()
    phase1()
    record = phase2()
    launches = phase3()
    phase4()
    print(json.dumps({"kernels": [{
        "name": "elementwise_block",
        "route": "cuda",
        "source": "tritd_tpu_torch/csrc/elementwise_block.cu",
        "replaces": "tritd_tpu/ops/pallas_kernels.py:133",
        "launches": launches,
        **record,
    }]}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
