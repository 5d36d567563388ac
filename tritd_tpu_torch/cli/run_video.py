"""Video background-modeling driver — `video_triple_comparison.m` protocol.

Counterpart of `tritd_tpu/cli/run_video.py`: CDnet sequences as (H, W, T)
grayscale tensors, missing rate 0 by default, the robust solver with the
video preset (`--method triple`, `VIDEO_TRITD`), the nonconvex variant
(`--method outlier`, `OutlierConfig`), or a baseline under its video-driver
preset (`ttnn`, `ring`, `fctn`, `sofia`; see run_completion.run_method).
Each dataset gives one JSON row with RMSE/NRMSE on the
missing entries, of the sparse part against the observed entries and of the
total reconstruction, PSNR/SSIM, and F1/PWC/mAP foreground scores when
ground-truth labels exist (for a synthetic stand-in, its own moving-object
truth). It saves `<name>_raw` and `<name>_<method>_{errHist,Xhat,O}`.

Usage:
  python -m tritd_tpu_torch.cli.run_video --datasets highway \\
      --method triple --out-dir results
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..data import load_dataset, load_groundtruth, synthetic_video_truth, uniform_missing_mask
from ..metrics.foreground import foreground_scores, mean_average_precision
from ..metrics.image import quality
from ..metrics.recon import evaluate
from ..ops.designs import triple_product
from ..solvers import OutlierConfig, trim_history, tritd_admm, tritd_admm_outlier
from ..utils import artifacts
from ..utils.config import VIDEO_DATASETS, VIDEO_TRITD
from ..utils.published import check_parity
from .run_completion import SVT_METHODS, resolve_device, run_method, timed

METHOD_NAMES = ("triple", "outlier", "ttnn", "ring", "fctn", "sofia")


def solve(method, y, x, mask, spec, seed, max_iter, svt_method="svd"):
    """Run one method; returns (x_hat, o, err_hist as numpy)."""
    generator = torch.Generator().manual_seed(seed)
    if method == "triple":
        cfg = dataclasses.replace(VIDEO_TRITD, max_iter=max_iter)
        res = tritd_admm(y, cfg, origin=x, generator=generator)
    elif method == "outlier":
        res = tritd_admm_outlier(y, OutlierConfig(rank=5, max_iter=max_iter), generator=generator)
    else:
        return run_method(method, y, x, mask, spec, generator, max_iter, svt_method=svt_method)
    return triple_product(res.a, res.b, res.c), res.o, trim_history(res.err_hist, res.n_iters)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datasets", nargs="+", default=list(VIDEO_DATASETS))
    p.add_argument("--method", default="triple", choices=METHOD_NAMES)
    p.add_argument("--missing-ratio", type=float, default=0.0)
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fg-threshold", type=float, default=50.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; fails if absent)")
    p.add_argument("--svt-method", default="svd",
                   help="SVT route for the SVT-ADMM baselines (see run_completion)")
    p.add_argument(
        "--verify-parity", action="store_true",
        help="after the run, assert every row beats the reference's"
        " published wall-clock (README.md:71-77, the only per-cell video"
        " number the reference publishes) and exit nonzero otherwise;"
        " requires the real .mat sequences (synthetic stand-ins fail"
        " loudly, see docs/DATA.md)",
    )
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    rows = []
    for name in args.datasets:
        x_np, spec, provenance = load_dataset(name, args.data_dir)
        x = torch.as_tensor(x_np, dtype=torch.float32, device=device)
        mask = torch.as_tensor(
            uniform_missing_mask(np.random.default_rng(args.seed), x.shape, args.missing_ratio),
            device=device,
        )
        y = torch.where(mask, x, torch.zeros_like(x))
        artifacts.save_raw(args.out_dir, name, y.cpu().numpy())
        print(f"===== Dataset: {name} ({provenance}) shape={tuple(x.shape)} device={device} =====")

        run = lambda: solve(args.method, y, x, mask, spec, args.seed, args.max_iter,  # noqa: E731
                            svt_method=args.svt_method)
        (x_hat, o, err_hist), elapsed = timed(device, run)
        first_call_s, timing = elapsed, "first_call"
        if args.verify_parity:
            # the published MATLAB times hold no one-time set-up (library
            # build, cuBLAS/cuSOLVER initialisation): re-time a warm solve
            (x_hat, o, err_hist), elapsed = timed(device, run)
            timing = "warm"

        zero = torch.zeros((), device=device)
        rmse_m, nrmse_m = evaluate(x_hat, x, ~mask) if args.missing_ratio else (zero, zero)
        rmse_o, nrmse_o = evaluate(o, x, mask)
        rmse_t, nrmse_t = evaluate(x_hat + o, x, None)
        psnr_v, ssim_v = quality(x, x_hat)
        row = {
            "dataset": name,
            "method": args.method,
            "seconds": round(elapsed, 3),
            "timing": timing,
            **({"seconds_first_call": round(first_call_s, 3)} if timing == "warm" else {}),
            **({"svt_method": args.svt_method} if args.method in SVT_METHODS else {}),
            "iters": int(len(err_hist)),
            "rmse_missing": float(rmse_m),
            "nrmse_missing": float(nrmse_m),
            "rmse_sparse": float(rmse_o),
            "nrmse_sparse": float(nrmse_o),
            "rmse_total": float(rmse_t),
            "nrmse_total": float(nrmse_t),
            "psnr": float(psnr_v),
            "ssim": float(ssim_v),
            "provenance": provenance,
            "device": str(device),
        }

        o_np = o.cpu().numpy()
        gt = load_groundtruth(name, args.data_dir)
        if gt is None and provenance == "synthetic":
            # the stand-in's own moving-object truth, in the CDnet 0/255
            # labels so the scorer's non-ROI handling stays exercised
            _, _, fg_mask = synthetic_video_truth(spec)
            gt = np.where(fg_mask, 255.0, 0.0)
        if gt is not None:
            scores = foreground_scores(o_np, gt, args.fg_threshold)
            row.update(
                precision=scores.precision, recall=scores.recall,
                f1=scores.f1, pwc=scores.pwc,
                map=mean_average_precision(o_np, gt),
            )

        artifacts.save_artifact(args.out_dir, name, args.method, "errHist", err_hist)
        artifacts.save_artifact(args.out_dir, name, args.method, "Xhat", x_hat.cpu().numpy())
        artifacts.save_artifact(args.out_dir, name, args.method, "O", o_np)
        rows.append(row)
        print(json.dumps(row))

    if args.verify_parity:
        failures = check_parity(rows, max_iter=args.max_iter, missing_ratio=args.missing_ratio)
        if failures:
            for msg in failures:
                print(f"PARITY FAIL {msg}")
            raise SystemExit(1)
        print(f"PARITY OK: {len(rows)} rows beat README.md:71-77 wall-clock")
    return rows


def console_main() -> None:
    """Entry point of the installed console script: `main` returns its rows,
    which a console script would hand to `sys.exit` as an error."""
    main()


if __name__ == "__main__":
    main()
