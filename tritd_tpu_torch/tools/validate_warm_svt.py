"""Validation of the warm-started SVT ("warm:<K>") against the exact
Gram-eigh path, per baseline method and benchmark dataset.

Counterpart of the JAX package's `tools/validate_warm_svt.py`. The
expensive case is any unfolding with a big thin side: chicago's 4-way
bipartition 5929x2016 (RC-FCTN), its TT cut 5929x2016 (TTNN) and its
circular unfolding 5929x2016 (RING) all pay a thin-side eigh per iteration
on the exact path, and the retained spectrum is NOT low-rank (>= 76%), so
the randomized top-k route is invalid. The warm route reuses the previous
refresh's singular basis and refreshes the exact Gram-eigh every K-th
iteration (`ops/svt.py::svt_ref_compat_warm` / `svt_warm`).

Protocol: `cli.run_completion.run_method` with the driver presets, 10%
uniform missing (video: nothing missing), origin-oracle err_hist; the exact
"gram" route is the reference, warm:K the candidate. Each route is solved
twice and the second solve is timed, so one-time library set-up stays out.

Usage: python -m tritd_tpu_torch.tools.validate_warm_svt
       [--method fctn|ttnn|ring] [--dataset chicago] [--iters 100]
       [--ks 2,4,8] [--data-seeds 1,2] [--device cuda] [--out result.json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..cli.run_completion import resolve_device, run_method, timed
from ..data import load_dataset, uniform_missing_mask
from ..data.loaders import DATASETS, synthetic_traffic


def _compare(hw: np.ndarray, hg: np.ndarray, xw: torch.Tensor, xg: torch.Tensor) -> dict:
    adiff = np.abs(hw - hg)
    worst = int(np.argmax(adiff))
    return {
        "max_abs_hist_diff": float(adiff.max()),
        "argmax_hist_diff_iter": worst,
        "hist_gram_at_argmax": float(hg[worst]),
        "max_rel_hist_diff": float(np.max(adiff / np.maximum(hg, 1e-12))),
        "rel_final_x_diff": float(torch.linalg.vector_norm(xw - xg) / torch.linalg.vector_norm(xg)),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--method", default="fctn", choices=("fctn", "ttnn", "ring"))
    p.add_argument("--dataset", default="chicago")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--ks", default="2,4,8")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--data-seeds", default=None,
                   help="comma-separated seeds: draw a FRESH mixed-family traffic stand-in at the"
                   " dataset's shape per seed (basis drift depends on the data; this hardens"
                   " the one-seed validation)")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ks = [int(v) for v in a.ks.split(",")]

    x_np, spec, prov = load_dataset(a.dataset)
    missing_ratio = 0.0 if spec.kind == "video" else 0.10

    def problem_for(x_np):
        x = torch.as_tensor(x_np, dtype=torch.float32, device=device)
        mask = torch.as_tensor(
            uniform_missing_mask(np.random.default_rng(0), x.shape, missing_ratio), device=device)
        return x, mask, torch.where(mask, x, torch.zeros_like(x))

    def solve(problem, route, reps=2):
        x, mask, y = problem
        for _ in range(reps):
            (xh, _o, hist), dt = timed(device, lambda: run_method(
                a.method, y, x, mask, spec, torch.Generator().manual_seed(0), a.iters, svt_method=route))
        print(f"  {route}: {dt:.2f}s err[first,last]={hist[0]:.4g},{hist[-1]:.4g}", flush=True)
        return xh, hist, dt

    if a.data_seeds is not None:
        if spec.kind != "traffic":
            raise SystemExit("--data-seeds sweeps traffic stand-ins")
        sweep = []
        for seed in (int(s) for s in a.data_seeds.split(",")):
            problem = problem_for(synthetic_traffic(DATASETS[a.dataset], np.random.default_rng(seed)))
            print(f"data seed {seed}:", flush=True)
            xg, hg, _ = solve(problem, "gram", reps=1)
            for kk in ks:
                xw, hw, _ = solve(problem, f"warm:{kk}", reps=1)
                sweep.append({"seed": seed, "method": f"warm:{kk}", **_compare(hw, hg, xw, xg)})
        result = {
            "protocol": {"solver": a.method, "dataset_shape_of": a.dataset, "iters": a.iters,
                         "missing_ratio": missing_ratio, "device": str(device),
                         "fresh_mixed_family_standin_per_seed": True},
            "sweep": sweep,
            "worst_max_abs_hist_diff": max(r["max_abs_hist_diff"] for r in sweep),
            "worst_rel_final_x_diff": max(r["rel_final_x_diff"] for r in sweep),
        }
    else:
        problem = problem_for(x_np)
        xg, hg, tg = solve(problem, "gram")
        rows = []
        for kk in ks:
            xw, hw, tw = solve(problem, f"warm:{kk}")
            rows.append({"method": f"warm:{kk}", "seconds": round(tw, 3), **_compare(hw, hg, xw, xg),
                         "speedup_vs_gram": round(tg / tw, 2)})
        result = {
            "protocol": {"solver": a.method, "dataset": a.dataset, "shape": list(problem[0].shape),
                         "iters": a.iters, "provenance": prov, "missing_ratio": missing_ratio,
                         "device": str(device), "gram_seconds": round(tg, 3),
                         "err_last_gram": float(hg[-1])},
            "rows": rows,
        }
    print(json.dumps(result, indent=1))
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {a.out}")
    return result


if __name__ == "__main__":
    main()
