#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tritd_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run by raising:
  0. require CUDA; turn TF32 off; print the card, its power limit and versions.
  1. build the hand-written kernel (csrc/elementwise_block.cu) with nvcc.
  2. hold each kernel variant against its plain PyTorch version on the card:
     float32 and float64 at the taxi, video, a ragged and a one-element
     shape, with and without T'; the narrow variants (bf16 storage with bf16
     T', float32 storage with bf16 T', masked bf16 storage without T') at
     the taxi and video shapes, where T' must also be bitwise the rounding
     of D - O' + Y_L'/muL_next from the kernel's own stored O' and Y_L'.
     Time both with CUDA events.
  3. the main path: robust TriTD-ADMM on the taxi completion stand-in
     (100x100x500, r=5, 10% missing, COMPLETION_TRITD, 100 iterations, f32),
     checked against a float64 CPU rerun of its first 10 iterations, and on
     the video stand-in (240x320x300, VIDEO_TRITD, 100 iterations); then
     taxi and highway with storage_dtype="bfloat16", taxi with
     einsum_dtype="bfloat16", and masked taxi in float32 and bf16 storage,
     each held to its float32 run's RRE within 0.03.
  4. the completion CLI in a subprocess.
  5. checkpointed resume: a subprocess dies right after its step-25
     checkpoint (exit 17); the resume here is bitwise equal to an
     uninterrupted checkpointed run and within rtol 1e-6 of tritd_admm.
  6. the other solvers: tritd_admm_outlier on the highway stand-in,
     tritd_als and tritd_mals on the taxi stand-in.
  7. the video CLI in a subprocess at 240x320x300, 100 iterations.

Each solve counts the kernel's launches from zero and must launch its
variant once per iteration. The line before the last is a JSON object with
one record per kernel variant of the main path; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or tritd_tpu.
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
from tritd_tpu_torch.solvers import (  # noqa: E402
    OutlierConfig,
    TriTDConfig,
    init_factors,
    trim_history,
    tritd_admm,
    tritd_admm_checkpointed,
    tritd_admm_outlier,
    tritd_als,
    tritd_mals,
)
from tritd_tpu_torch.utils.config import COMPLETION_TRITD, README_MISSING_RATIO, VIDEO_TRITD  # noqa: E402

KERNEL_SHAPES = {
    "taxi": (100, 100, 500),
    "video": (240, 320, 300),
    "ragged": (17, 23, 31),
    "one": (1, 1, 1),
}
# narrow variants: (D, storage, T') dtypes, compute float32; T' None = no T'
NARROW = {
    "c32_dbf16_sbf16_tbf16": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    "c32_d32_s32_tbf16": (torch.float32, torch.float32, torch.bfloat16),
    "c32_d32_sbf16_tbf16": (torch.float32, torch.bfloat16, None),
}
SCALARS = (0.5, 0.7, 1.8)  # mu_l, mu_o, lam
MU_NEXT = 0.625
REPS = 20
BATCH = 10
RRE_FAMILY = 0.03  # bf16 vs f32 RRE bound of the reference's own test


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


def _block_bytes(args, t_dtype) -> int:
    """Bytes the block must move: its five inputs, four outputs in the
    storage dtype, and T' when built."""
    d, l, e = args[0], args[1], args[2]
    per = d.element_size() + l.element_size() + 3 * e.element_size() + 4 * e.element_size()
    if t_dtype is not None:
        per += torch.empty((), dtype=t_dtype).element_size()
    return per * d.numel()


def _report(tag, args, t_dtype, max_abs, ms, plain_ms) -> None:
    n_bytes = _block_bytes(args, t_dtype)
    print(f"phase2 {tag} max_abs_err={max_abs:.3e} kernel={ms * 1e3:9.1f} us "
          f"({n_bytes / ms / 1e6:7.1f} GB/s) plain={plain_ms * 1e3:9.1f} us "
          f"({n_bytes / plain_ms / 1e6:7.1f} GB/s) bytes/elem={n_bytes // args[0].numel()}")


def phase2() -> dict:
    """Kernel vs plain version on the card. Same-dtype variants: tensors
    rtol 1e-6 with atol 1e-6 * max|input| (nvcc contracts a*b+c into one
    FMA); narrow variants: `hopper_kernels.check_narrow_against_plain` -
    bf16 tensors within one bf16 ulp, rtol 2**-8 with atol 2**-8 *
    max|input| (such an FMA can flip one rounding), with at most a share
    NARROW_FLIP_SHARE of their elements rounded otherwise, and T' bitwise
    from the stored O' and Y_L'; norms rtol 1e-5 (the kernel sums in
    double, the plain version in the dtype).
    Returns the taxi-shape record of each variant the main path runs."""
    records = {}
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
            t_dtype = None if mu_next is None else dtype
            _report(f"{name:6s} {str(dtype)[6:]:7s} t'={'yes' if mu_next else 'no '}",
                    args, t_dtype, max_abs, ms, plain_ms)
            if name == "taxi" and dtype == torch.float32 and mu_next is not None:
                records["f32"] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}

    for seed, (variant, (d_dt, s_dt, t_dt)) in enumerate(NARROW.items(), start=100):
        for name in ("taxi", "video"):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            raw = [torch.randn(KERNEL_SHAPES[name], generator=gen, device="cuda") * 3 for _ in range(5)]
            args = [raw[0].to(d_dt), raw[1], *(x.to(s_dt) for x in raw[2:])]
            if hopper_kernels.kernel_variant(*args, t_dtype=t_dt) != variant:
                raise AssertionError(f"{variant}: dtypes route to another variant")
            mu_next = None if t_dt is None else MU_NEXT
            kw = dict(mu_l_next=mu_next, t_dtype=t_dt)
            plain_kw = dict(mu_l_next=mu_next, compute_dtype=torch.float32, store_dtype=s_dt, t_dtype=t_dt)
            got = hopper_kernels._block_cuda(*args, *SCALARS, **kw)
            want = hopper_kernels._block_torch(*args, *SCALARS, **plain_kw)
            torch.cuda.synchronize()
            agree = hopper_kernels.check_narrow_against_plain(args, got, want, mu_next)
            max_abs = agree["max_abs_err"]
            for i in (4, 5):
                torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0.0)
            ms, plain_ms = _time_pair(
                lambda: hopper_kernels._block_torch(*args, *SCALARS, **plain_kw),
                lambda: hopper_kernels._block_cuda(*args, *SCALARS, **kw),
            )
            _report(f"{name:6s} {variant}", args, t_dt, max_abs, ms, plain_ms)
            print(f"phase2 {name:6s} {variant} bf16 elements rounded otherwise than the plain version: "
                  f"share {agree['flip_share']:.3e} (limit {hopper_kernels.NARROW_FLIP_SHARE:.0e}); "
                  f"T' bitwise from the stored O', Y_L'")
            if name == "taxi":
                records[variant] = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
    return records


def _launches() -> dict:
    """The kernel variants launched since the last reset, with their counts."""
    return {k[len("elementwise_block["):-1]: v for k, v in hopper_kernels.LAUNCHES.items() if v}


def _solve(y, cfg, init, origin=None, mask=None) -> tuple:
    """One timed solve: CUDA events around it and a final synchronize. A
    3-iteration solve first takes the one-time cuBLAS/cuSOLVER set-up out of
    the timed run; the launch counts cover the timed run only."""
    tritd_admm(y, dataclasses.replace(cfg, max_iter=3), origin=origin, init=init, mask=mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hopper_kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = tritd_admm(y, cfg, origin=origin, init=init, mask=mask)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, _launches(), start.elapsed_time(end) / 1e3, wall


def _check_run(tag, res, launches, variant, dev_s, wall, truth) -> tuple[float, np.ndarray]:
    n = res.n_iters
    err = trim_history(res.err_hist, n)
    if launches != {variant: n}:
        raise AssertionError(f"{tag}: launches {launches}, want {{{variant!r}: {n}}}")
    if not (np.isfinite(err).all() and err[-1] < err[0]):
        raise AssertionError(f"{tag}: err_hist not finite and falling: {err}")
    if res.o.dtype != torch.float32:
        raise AssertionError(f"{tag}: O comes back in {res.o.dtype}")
    rre_truth = float(rre(triple_product(res.a, res.b, res.c), truth))
    if not (np.isfinite(rre_truth) and rre_truth < 1.0):
        raise AssertionError(f"{tag}: RRE vs truth {rre_truth}")
    print(f"phase3 {tag}: iters={n} launches={launches} solve={dev_s:.4f} s (events) {wall:.4f} s (wall) "
          f"{dev_s / n * 1e3:.3f} ms/iter peak_mem={torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"rre={rre_truth:.6f} err[0]={err[0]:.4e} err[-1]={err[-1]:.4e}")
    return rre_truth, err


def _taxi():
    x_np, _spec, prov = load_dataset("taxi")
    mask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO),
                           device="cuda")
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    return x, mask, torch.where(mask, x, torch.zeros_like(x)), prov


def phase3() -> dict:
    """The main path; returns the launches of each kernel variant in it."""
    total: dict = {}

    def run(tag, y, cfg, init, variant, truth, origin=None, mask=None):
        res, launches, dev_s, wall = _solve(y, cfg, init, origin=origin, mask=mask)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return (res, *_check_run(tag, res, launches, variant, dev_s, wall, truth))

    # taxi completion: the primary row of the reference benchmark
    x, mask, y, prov = _taxi()
    cfg = COMPLETION_TRITD
    init = init_factors(torch.Generator().manual_seed(0), x.shape, cfg.rank, torch.float32)
    res, rre32, err = run(f"taxi ({prov}) 100x100x500 r=5 f32", y, cfg, init, "f32", x, origin=x)

    # the first 10 iterations again, float64 on the CPU, from the same init
    cpu = tritd_admm(y.cpu().double(), dataclasses.replace(cfg, dtype="float64", max_iter=10),
                     origin=x.cpu().double(), init=init)
    m = min(cpu.n_iters, res.n_iters)
    ref = trim_history(cpu.err_hist, m)
    np.testing.assert_allclose(err[:m], ref, rtol=1e-3)
    print(f"phase3 taxi f32 cuda vs f64 cpu, first {m} iterations: "
          f"max rel diff {np.max(np.abs(err[:m] - ref) / np.abs(ref)):.3e} (rtol 1e-3)")

    # video protocol: fully observed
    v_np, _vspec, vprov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    vinit = init_factors(torch.Generator().manual_seed(0), v.shape, VIDEO_TRITD.rank, torch.float32)
    _, vrre32, _ = run(f"video highway ({vprov}) 240x320x300 r=5 f32", v, VIDEO_TRITD, vinit, "f32", v)

    # narrow storage and the bf16 einsum (the reference bench's bf16 rows)
    narrow = [
        ("taxi storage=bf16", y, dataclasses.replace(cfg, storage_dtype="bfloat16"), init,
         "c32_dbf16_sbf16_tbf16", x, rre32),
        ("video highway storage=bf16", v, dataclasses.replace(VIDEO_TRITD, storage_dtype="bfloat16"), vinit,
         "c32_dbf16_sbf16_tbf16", v, vrre32),
        ("taxi einsum=bf16", y, dataclasses.replace(cfg, einsum_dtype="bfloat16"), init,
         "c32_d32_s32_tbf16", x, rre32),
    ]
    for tag, data, ncfg, ninit, variant, truth, wide_rre in narrow:
        origin = truth if truth is x else None
        _, nrre, _ = run(tag, data, ncfg, ninit, variant, truth, origin=origin)
        if abs(nrre - wide_rre) > RRE_FAMILY:
            raise AssertionError(f"{tag}: RRE {nrre} vs f32 {wide_rre}, beyond {RRE_FAMILY}")

    # masked imputation, f32 and bf16 storage
    mcfg = dataclasses.replace(cfg, masked=True)
    _, mrre32, _ = run("taxi masked f32", y, mcfg, init, "f32", x, origin=x, mask=mask)
    _, mrre16, _ = run("taxi masked storage=bf16", y, dataclasses.replace(mcfg, storage_dtype="bfloat16"),
                       init, "c32_d32_sbf16_tbf16", x, origin=x, mask=mask)
    if abs(mrre16 - mrre32) > RRE_FAMILY:
        raise AssertionError(f"taxi masked: bf16 RRE {mrre16} vs f32 {mrre32}, beyond {RRE_FAMILY}")
    return total


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


_DRILL = """
import dataclasses, sys, numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
from tritd_tpu_torch.solvers import tritd_admm_checkpointed
from tritd_tpu_torch.utils.config import COMPLETION_TRITD
y = torch.from_numpy(np.load(sys.argv[1])).cuda()
tritd_admm_checkpointed(y, dataclasses.replace(COMPLETION_TRITD, max_iter=50), sys.argv[2], every=25)
sys.exit(3)
"""


def phase5() -> None:
    """Checkpointed resume on the card (taxi, f32, every=25, 50 iterations)."""
    _x, _mask, y, _prov = _taxi()
    cfg = dataclasses.replace(COMPLETION_TRITD, max_iter=50)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "y.npy"), y.cpu().numpy())
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _DRILL, os.path.join(tmp, "y.npy"), ckpt],
            capture_output=True, text=True, cwd=HERE, timeout=600,
            env=dict(os.environ, TRITD_DIE_AFTER_SAVE_STEP="25"),
        )
        if proc.returncode != 17:
            raise RuntimeError(f"kill drill: exit {proc.returncode}, want 17:\n{proc.stdout}\n{proc.stderr}")
        if sorted(os.listdir(ckpt)) != ["step_000025.npz"]:
            raise AssertionError(f"kill drill left {sorted(os.listdir(ckpt))}")
        drill_s = time.perf_counter() - t0
        hopper_kernels.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        resumed = tritd_admm_checkpointed(y, cfg, ckpt, every=25)
        end.record()
        torch.cuda.synchronize()
        resume_launches = _launches()
        hopper_kernels.reset_launch_counts()
        t1 = time.perf_counter()
        full = tritd_admm_checkpointed(y, cfg, os.path.join(tmp, "full"), every=25)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t1
        full_launches = _launches()
    if resumed.n_iters != 50 or resume_launches != {"f32": 25} or full_launches != {"f32": 50}:
        raise AssertionError(f"resume: n_iters {resumed.n_iters}, launches {resume_launches} / {full_launches}")
    for f in ("err_hist", "a", "b", "c", "o", "e"):
        torch.testing.assert_close(getattr(resumed, f), getattr(full, f), rtol=0, atol=0, equal_nan=True)
    mono = tritd_admm(y, cfg)
    np.testing.assert_allclose(resumed.err_hist.cpu().numpy(), mono.err_hist.cpu().numpy(), rtol=1e-6)
    same = bool(torch.equal(resumed.err_hist, mono.err_hist))
    print(f"phase5 checkpoint: drill exit 17 after step 25 in {drill_s:.2f} s (subprocess); resume 25->50 "
          f"{start.elapsed_time(end) / 1e3:.4f} s (events); uninterrupted 50 iterations with 2 saves "
          f"{full_s:.4f} s (wall); resumed == uninterrupted bitwise; vs tritd_admm rtol 1e-6 "
          f"(bitwise: {same})")


def phase6() -> None:
    """The other first-party solvers on the card."""
    def timed(fn):
        hopper_kernels.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end) / 1e3

    v_np, _spec, _prov = load_dataset("highway")
    v = torch.as_tensor(v_np, dtype=torch.float32, device="cuda")
    x_np, _spec, _prov = load_dataset("taxi")
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    tritd_admm_outlier(v, OutlierConfig(max_iter=2), generator=gen())  # set-up out of the timing
    runs = [
        ("outlier highway 240x320x300", lambda: tritd_admm_outlier(v, OutlierConfig(), generator=gen())),
        ("als taxi 100x100x500", lambda: tritd_als(x, TriTDConfig(), generator=gen())),
        ("mals taxi 100x100x500", lambda: tritd_mals(x, TriTDConfig(), generator=gen())),
    ]
    for tag, fn in runs:
        res, dev_s = timed(fn)
        n = res.n_iters
        err = trim_history(res.err_hist, n)
        if not (n > 1 and np.isfinite(err).all() and err[-1] < err[0]):
            raise AssertionError(f"{tag}: err_hist not finite and falling over {n} iterations: {err}")
        print(f"phase6 {tag}: iters={n} solve={dev_s:.4f} s (events) {dev_s / n * 1e3:.3f} ms/iter "
              f"err[0]={err[0]:.4e} err[-1]={err[-1]:.4e}")


def phase7() -> None:
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tritd_tpu_torch.cli.run_video", "--datasets", "highway",
             "--method", "triple", "--out-dir", out],
            capture_output=True, text=True, cwd=HERE, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"video CLI failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        row = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
        bad = [k for k in ("psnr", "ssim", "f1", "pwc", "map") if not np.isfinite(row.get(k, np.nan))]
        if bad or row["device"] != "cuda" or row["iters"] != 100 or row["dataset"] != "highway":
            raise AssertionError(f"video CLI row (not finite: {bad}): {row}")
        for what in ("errHist", "Xhat", "O"):
            if not os.path.exists(os.path.join(out, f"highway_triple_{what}.npz")):
                raise AssertionError(f"video CLI artifact {what} missing")
        print(f"phase7 video cli ({time.perf_counter() - t0:.1f} s in all): {json.dumps(row)}")


def main() -> None:
    device = phase0()
    phase1()
    records = phase2()
    launches = phase3()
    phase4()
    phase5()
    phase6()
    phase7()
    missing = sorted(set(records) - set(launches))
    if missing:
        raise AssertionError(f"kernel variants not launched by the main path: {missing}")
    print(json.dumps({"kernels": [{
        "name": "elementwise_block",
        "variant": variant,
        "route": "cuda",
        "source": "tritd_tpu_torch/csrc/elementwise_block.cu",
        "replaces": "tritd_tpu/ops/pallas_kernels.py:133",
        "launches": launches[variant],
        **record,
    } for variant, record in records.items()]}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
