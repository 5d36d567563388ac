"""Full-protocol parity of the port's solvers with the MATLAB-semantics
emulator, on any device.

Counterpart of the JAX package's `tools/emulator_parity.py`. Each solver
runs twice on the same data and the same injected inits:

* the port (`tritd_admm`, `tt_trpca`, `rtrc`, the RC-FCTN drivers,
  `sofia_init`) on `--device` in `--dtype` (float64 by default), and
* the port's own copy of the independent float64 numpy emulator
  (`tritd_tpu_torch/oracle/matlab_emulator.py`: order='F' reshapes, pinv
  solves, the reference's control flow),

and the whole err_hist trajectories are compared (max |difference|, final
values, iteration counts). On the card in float64 `triple` runs through
the f64 T' variant of the hand-written kernel, so agreement there holds the
kernel, the GEMMs and cuSOLVER to the protocol, not only to a plain
version; each row counts the kernel's launches (`kernel_launches`; `pointer_launches` those
through its pointer entry, which the solve's CUDA graph launches).

Data: the port's `load_dataset` (the numpy stand-in of the published shape
when no .mat file is present), 10% uniform missing from
`numpy.random.default_rng(0)`, zero-filled; `--data-seed` draws a fresh
stand-in of the same shape. The random inits (TriTD's normal cores,
SOFIA's uniform factors) are drawn once in numpy-compatible form and handed
to both sides.

Row fields: those of the reference's rows, with `_port` where the reference
says `_jax` (`n_iters_port`, `final_err_port`, `seconds_port`), plus
`device` and `kernel_launches`.

Usage:
  python -m tritd_tpu_torch.tools.emulator_parity --tiny [--device cpu]
      all five methods, 30 iterations, on a 9x7x24 completion problem
  python -m tritd_tpu_torch.tools.emulator_parity --tiny-video [--device cpu]
      the same under the video presets on a fully observed 20x24x24 tensor
  python -m tritd_tpu_torch.tools.emulator_parity --dataset taxi --method triple
      [--max-iter 100] [--data-seed N] [--out-dir results/emulator_parity]
      one protocol-scale row, written as <dataset>_<method>[_seedN].json
Exits 1 when a row fails its bar (`PASS_BAR`, and equal iteration counts).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..baselines.rc_fctn import rc_fctn_driver_traffic, rc_fctn_driver_video
from ..baselines.rtrc import rtrc
from ..baselines.sofia import sofia_init
from ..baselines.ttnn import tt_trpca
from ..cli.run_completion import resolve_device
from ..data import load_dataset, uniform_missing_mask
from ..data.loaders import DatasetSpec, synthetic_traffic
from ..data.synthetic import synthetic_video
from ..ops import hopper_kernels
from ..oracle import rc_fctn_em, rtrc_em, sofia_init_em, tritd_admm_em, tt_trpca_em
from ..solvers import init_factors, trim_history, tritd_admm
from ..utils.config import COMPLETION_TRITD, README_MISSING_RATIO, SOFIA_PRESET, VIDEO_TRITD

# The reference's bars on max|Δerr_hist| at protocol scale: float64 on both
# sides, so what is left is equivalent-but-different linear algebra
# (Cholesky against pinv ridge solves in triple, other LAPACK drivers in the
# SVT loops) over up to 100 iterations; sofia's nested early stops can flip
# an inner iteration count, hence its wider bar.
PASS_BAR = {"triple": 1e-5, "ttnn": 1e-5, "ring": 1e-5, "fctn": 1e-5, "sofia": 1e-4}
METHODS = ("triple", "ttnn", "ring", "fctn", "sofia")
TINY_ITERS = 30
DEFAULT_OUT_DIR = os.path.join("results", "emulator_parity")


@dataclasses.dataclass
class Problem:
    x: np.ndarray      # truth, float64
    y: np.ndarray      # observed, zero-filled, float64
    mask: np.ndarray   # bool, True = observed
    spec: DatasetSpec
    provenance: str


def problem(dataset: str, data_seed: int | None = None) -> Problem:
    x, spec, provenance = load_dataset(dataset)
    if data_seed is not None:
        x = synthetic_traffic(spec, np.random.default_rng(data_seed)).astype(np.float64)
        provenance = f"synthetic-seed{data_seed}"
    mask = uniform_missing_mask(np.random.default_rng(0), x.shape, README_MISSING_RATIO)
    return Problem(x, np.where(mask, x, 0.0), mask, spec, provenance)


def tiny_problem() -> Problem:
    """A small completion problem with mixed structure and 10% missing."""
    spec = DatasetSpec("tiny", "traffic", "T", (9, 7, 24), fctn_subdim=4, sofia_period=6)
    x = synthetic_traffic(spec, np.random.default_rng(7)).astype(np.float64)
    mask = uniform_missing_mask(np.random.default_rng(0), x.shape, 0.10)
    return Problem(x, np.where(mask, x, 0.0), mask, spec, "synthetic")


def tiny_video_problem() -> Problem:
    """A small video-protocol problem, fully observed: the video presets
    (VIDEO_TRITD, ring mu 1e-3, the fctn video split, sofia m = 1)."""
    spec = DatasetSpec("tinyvid", "video", "gray_images", (20, 24, 24), fctn_subdim=4, sofia_period=1)
    observed, _bg, _fg = synthetic_video(np.random.default_rng(3), spec.shape)
    x = np.asarray(observed, np.float64)
    return Problem(x, x.copy(), np.ones(x.shape, bool), spec, "synthetic")


def inits(method: str, prob: Problem) -> dict:
    """The random draws both sides start from, as float64 numpy arrays."""
    if method == "triple":
        rank = (VIDEO_TRITD if prob.spec.kind == "video" else COMPLETION_TRITD).rank
        cores = init_factors(torch.Generator().manual_seed(0), prob.x.shape, rank, torch.float64, "cpu")
        return {"cores": tuple(c.numpy() for c in cores)}
    if method == "sofia":
        g = np.random.default_rng(0)
        return {"u_init": tuple(g.random((n, SOFIA_PRESET.rank)) for n in prob.x.shape)}
    return {}


def _ring_mu(spec) -> float:
    return 1e-3 if spec.kind == "video" else 1e-1  # `video...m:156` / `traffic...m:139`


def _fctn_setup(prob: Problem):
    """The 4-way split, lambda, f and indicator of the two RC-FCTN drivers
    (`video_triple_comparison.m:240-262`, `traffic...m:157-158`)."""
    i, j, k = prob.x.shape
    sub = prob.spec.fctn_subdim
    if prob.spec.kind == "video":
        shape4 = (i, j, sub, k // sub)
        return shape4, 1.8, 0.7, np.reshape(prob.mask.astype(np.float64), shape4, order="F")
    shape4 = (i, j, k // sub, sub)
    lam = 5000.0 / math.sqrt(max(i, j) * (k // sub) * sub)
    return shape4, lam, 0.1, np.ones(shape4)  # the traffic driver marks everything observed


def _host(h) -> np.ndarray:
    if isinstance(h, torch.Tensor):
        h = h.detach().cpu().numpy()
    return np.asarray(h, np.float64)


def port_side(method: str, prob: Problem, max_iter: int, device, dtype, drawn: dict) -> dict:
    """Run the port's solver; returns hist, n_iters, seconds, launches."""
    device = torch.device(device)
    x = torch.as_tensor(prob.x, dtype=dtype, device=device)
    y = torch.as_tensor(prob.y, dtype=dtype, device=device)
    mask = torch.as_tensor(prob.mask, device=device)
    video = prob.spec.kind == "video"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    hopper_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    extra = {}
    if method == "triple":
        base = VIDEO_TRITD if video else COMPLETION_TRITD
        cfg = dataclasses.replace(base, dtype=str(dtype).removeprefix("torch."), max_iter=max_iter)
        res = tritd_admm(y, cfg, origin=x, init=drawn["cores"])
        n = int(res.n_iters)
        hist = trim_history(res.err_hist, n)
        extra["rre"] = trim_history(res.rre_hist, n)
    elif method == "ttnn":
        _z, _s, hist, n = tt_trpca(y, origin=x, max_iter=max_iter, svt_method="svd")
    elif method == "ring":
        _x, _y, hist, n = rtrc(y, mask, mu=_ring_mu(prob.spec), origin=x, max_iter=max_iter, svt_method="svd")
    elif method == "fctn":
        driver = rc_fctn_driver_video if video else rc_fctn_driver_traffic
        _x, _s, hist = driver(y, mask, prob.spec.fctn_subdim, origin=x, max_iter=max_iter, svt_method="svd")
        n = max_iter
    elif method == "sofia":
        p = SOFIA_PRESET
        _u, _x, _o, hist = sofia_init(
            y, mask, p.rank, prob.spec.sofia_period, p.lambda1, p.lambda2, p.lambda3, origin=x,
            max_epoch=min(p.max_epoch, max_iter), tol=p.tol, u_init=drawn["u_init"], dtype=dtype,
        )
        n = len(hist)
    else:
        raise ValueError(f"unknown method {method!r}; known: {METHODS}")
    hist = _host(hist)
    sync()
    seconds = time.perf_counter() - t0
    launches = {k[len("elementwise_block["):-1]: v for k, v in hopper_kernels.LAUNCHES.items() if v}
    pointer = {k[len("elementwise_block_ptr["):-1]: v for k, v in hopper_kernels.POINTER_LAUNCHES.items() if v}
    return {"hist": hist, "n": int(n), "seconds": seconds, "launches": launches, "pointer_launches": pointer,
            **extra}


def emulator_side(method: str, prob: Problem, max_iter: int, drawn: dict) -> dict:
    """Run the float64 numpy emulator; returns hist, n_iters, seconds."""
    t0 = time.perf_counter()
    extra = {}
    if method == "triple":
        cfg = VIDEO_TRITD if prob.spec.kind == "video" else COMPLETION_TRITD
        a0, b0, c0 = drawn["cores"]
        em = tritd_admm_em(prob.y, a0, b0, c0, mu=cfg.mu, rho=cfg.rho, lam=cfg.lambda_l1, lam2=cfg.lambda2,
                           alpha_c=cfg.alpha_c, max_iter=max_iter, tol=cfg.tol, origin=prob.x)
        hist, n, extra["rre"] = em["err_hist"], em["n_iters"], em["rre_hist"]
    elif method == "ttnn":
        hist, n = tt_trpca_em(prob.y, prob.x, max_iter=max_iter)["err_hist"], max_iter
    elif method == "ring":
        em = rtrc_em(prob.y, prob.mask.astype(np.float64), prob.x, mu=_ring_mu(prob.spec), max_iter=max_iter)
        hist, n = em["err_hist"], max_iter
    elif method == "fctn":
        shape4, lam, f, ind = _fctn_setup(prob)
        em = rc_fctn_em(np.reshape(prob.y, shape4, order="F"), lam, ind, np.reshape(prob.x, shape4, order="F"),
                        f=f, gamma=1e-3, deta=1e-3, maxit=max_iter)
        hist, n = em["rse_real"], max_iter
    elif method == "sofia":
        p = SOFIA_PRESET
        em = sofia_init_em(prob.y, prob.mask, p.rank, prob.spec.sofia_period, p.lambda1, p.lambda2, p.lambda3,
                           drawn["u_init"], prob.x, max_epoch=min(p.max_epoch, max_iter), tol=p.tol)
        hist, n = em["err_hist"], em["n_epochs"]
    else:
        raise ValueError(f"unknown method {method!r}; known: {METHODS}")
    return {"hist": _host(hist), "n": int(n), "seconds": time.perf_counter() - t0, **extra}


def compare(method: str, port: dict, em: dict, device, dtype) -> dict:
    """One row: the two trajectories held to each other."""
    n = min(len(port["hist"]), len(em["hist"]), port["n"], em["n"])
    diff = np.abs(port["hist"][:n] - em["hist"][:n])
    row = {
        "method": method,
        "n_iters_port": port["n"],
        "n_iters_emulator": em["n"],
        "iters_match": port["n"] == em["n"],
        "max_abs_diff_err_hist": float(diff.max()) if n else None,
        "final_err_port": float(port["hist"][n - 1]) if n else None,
        "final_err_emulator": float(em["hist"][n - 1]) if n else None,
        "seconds_port": port["seconds"],
        "seconds_emulator": em["seconds"],
        "dtype": f"{str(dtype).removeprefix('torch.')}/float64",
        "device": str(device),
        "kernel_launches": port["launches"],
        "pointer_launches": port["pointer_launches"],
    }
    if "rre" in port:
        m = min(len(port["rre"]), len(em["rre"]), n)
        row["max_abs_diff_rre_hist"] = float(np.abs(port["rre"][:m] - em["rre"][:m]).max()) if m else None
    row["pass_bar"] = PASS_BAR[method]
    row["pass"] = bool(row["iters_match"] and n > 0 and row["max_abs_diff_err_hist"] <= PASS_BAR[method])
    return row


def run(method: str, prob: Problem, max_iter: int, device="cuda", dtype=torch.float64) -> dict:
    """Both sides of one row, one after the other."""
    drawn = inits(method, prob)
    port = port_side(method, prob, max_iter, device, dtype, drawn)
    return compare(method, port, emulator_side(method, prob, max_iter, drawn), device, dtype)


def _emulate(args):
    method, prob, max_iter, drawn = args
    return emulator_side(method, prob, max_iter, drawn)


def run_many(jobs, device="cuda", dtype=torch.float64, workers: int = 4) -> list[dict]:
    """Rows of `jobs` (method, problem, max_iter): the emulator sides run in
    `workers` spawned processes of one numpy thread each, while this
    process runs the port sides in order; rows come back in job order."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    drawn = [inits(m, prob) for m, prob, _ in jobs]
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})  # the children read these as they start
    try:
        pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
        futures = [pool.submit(_emulate, (m, prob, it, d)) for (m, prob, it), d in zip(jobs, drawn)]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with pool:
        ports = [port_side(m, prob, it, device, dtype, d) for (m, prob, it), d in zip(jobs, drawn)]
        return [compare(m, port, fut.result(), device, dtype)
                for (m, _prob, _it), port, fut in zip(jobs, ports, futures)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--tiny-video", action="store_true")
    ap.add_argument("--dataset")
    ap.add_argument("--method", choices=METHODS)
    ap.add_argument("--max-iter", type=int, default=100)
    ap.add_argument("--data-seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)

    if args.tiny or args.tiny_video:
        prob = tiny_video_problem() if args.tiny_video else tiny_problem()
        rows = []
        for m in METHODS:
            rows.append(run(m, prob, TINY_ITERS, device, dtype))
            print(json.dumps(rows[-1]), flush=True)
        ok = all(r["pass"] for r in rows)
        print(json.dumps({"tiny_all_pass": ok}))
        return 0 if ok else 1

    if not (args.dataset and args.method):
        ap.error("--dataset and --method are required without --tiny/--tiny-video")
    prob = problem(args.dataset, args.data_seed)
    row = run(args.method, prob, args.max_iter, device, dtype)
    row.update(dataset=args.dataset, shape=list(prob.x.shape), provenance=prob.provenance)
    os.makedirs(args.out_dir, exist_ok=True)
    seed_tag = "" if args.data_seed is None else f"_seed{args.data_seed}"
    with open(os.path.join(args.out_dir, f"{args.dataset}_{args.method}{seed_tag}.json"), "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row))
    return 0 if row["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
