"""Where a float8 solve turns NaN at full size, in the JAX package and in the
port's plain path, on the CPU: a record of how ROADMAP section 3 item 4 was
settled, not a tool of either package.

Three configurations, float32 compute, tol 0, 100 iterations, both packages
from the same init (the JAX package's draw from PRNGKey(0)): highway
240x320x300 under VIDEO_TRITD with float8_e5m2 and with float8_e4m3fn
storage, and taxi 100x100x500 (10% missing, zero-filled) under
COMPLETION_TRITD with a float8_e5m2 einsum. Each also runs with the input
moved by one float32 step (every entry up, every entry down): a change the
size of a rounding, which shows how far rounding alone moves the first
non-finite iteration and the iteration where two runs part.

Every run is its own process (one full-size problem in memory at a time).
Run from the repository root, on the CPU (about 20 minutes on 4 cores):

    JAX_PLATFORMS=cpu python docs/float8_nan_study.py --out-dir results/float8_nan

It prints, per configuration, each run's first non-finite iteration and,
for each pair of runs, the first iteration whose err_hist entries part by
more than chip_smoke.py phase 3 allows (1e-3 without feedback into the
factor solves; with an einsum dtype 1e-2 over the first four and 0.1 after).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ("highway_e5m2_storage", "highway_e4m3fn_storage", "taxi_e5m2_einsum")
RUNS = ("jax", "torch", "jax_up", "torch_up", "jax_down", "torch_down")


def _problem(config: str, iters: int):
    sys.path.insert(0, str(REPO))
    from tritd_tpu_torch.data import load_dataset
    from tritd_tpu_torch.data.synthetic import uniform_missing_mask
    from tritd_tpu_torch.utils.config import COMPLETION_TRITD, README_MISSING_RATIO, VIDEO_TRITD

    if config.startswith("highway"):
        y = load_dataset("highway")[0].astype(np.float32)
        storage = "float8_e5m2" if "e5m2" in config else "float8_e4m3fn"
        return y, dataclasses.replace(VIDEO_TRITD, max_iter=iters, tol=0.0, storage_dtype=storage)
    x = load_dataset("taxi")[0].astype(np.float32)
    mask = uniform_missing_mask(np.random.default_rng(0), x.shape, README_MISSING_RATIO)
    y = np.where(mask, x, np.float32(0.0))
    return y, dataclasses.replace(COMPLETION_TRITD, max_iter=iters, tol=0.0, einsum_dtype="float8_e5m2")


def run_one(config: str, run: str, iters: int, out: Path) -> None:
    """One solve; writes {first_nonfinite, err} to `out`."""
    y, cfg = _problem(config, iters)
    package, _, move = run.partition("_")
    if move:
        y = np.nextafter(y, np.float32(np.inf if move == "up" else -np.inf)).astype(np.float32)
    import jax
    import jax.numpy as jnp

    from tritd_tpu.solvers.admm import init_factors as j_init_factors

    if package == "jax":
        from tritd_tpu.solvers import TriTDConfig as JConfig
        from tritd_tpu.solvers import tritd_admm as j_tritd_admm

        res = j_tritd_admm(jnp.asarray(y), JConfig(**dataclasses.asdict(cfg)), key=jax.random.PRNGKey(0))
        err = np.asarray(res.err_hist, np.float64)
    else:
        import torch

        from tritd_tpu_torch.solvers import tritd_admm

        init = [np.asarray(u) for u in j_init_factors(jax.random.PRNGKey(0), y.shape, cfg.rank, jnp.float32)]
        err = tritd_admm(torch.from_numpy(y), cfg, init=init, device="cpu").err_hist.double().numpy()
    bad = ~np.isfinite(err)
    out.write_text(json.dumps({"first_nonfinite": int(np.argmax(bad)) + 1 if bad.any() else None,
                               "err": [float(e) for e in err]}))


def summary(out_dir: Path, iters: int) -> None:
    for config in CONFIGS:
        runs = {r: json.loads((out_dir / f"{config}_{r}.json").read_text()) for r in RUNS}
        if "einsum" in config:
            limits = np.array([1e-2 if k < 4 else 0.1 for k in range(iters)])
        else:
            limits = np.full(iters, 1e-3)
        print(f"{config}: first non-finite iteration " + ", ".join(f"{r} {v['first_nonfinite']}"
                                                                      for r, v in runs.items()))
        for a, b in itertools.combinations(RUNS, 2):
            ea, eb = np.array(runs[a]["err"]), np.array(runs[b]["err"])
            rel = np.abs(eb - ea) / np.abs(ea)
            over = np.flatnonzero(~(rel <= limits))
            print(f"  {a} / {b}: part past the limits at iteration {over[0] + 1 if over.size else None}; "
                  f"largest relative distance over the first 10 {np.nanmax(rel[:10]):.2e}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", required=True, type=Path)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--one", nargs=2, metavar=("CONFIG", "RUN"), help="run one solve in this process")
    args = p.parse_args()
    args.out_dir.mkdir(parents=True, exist_ok=True)
    if args.one:
        config, run = args.one
        run_one(config, run, args.iters, args.out_dir / f"{config}_{run}.json")
        return
    for config, run in itertools.product(CONFIGS, RUNS):
        if not (args.out_dir / f"{config}_{run}.json").exists():
            subprocess.run([sys.executable, __file__, "--out-dir", str(args.out_dir), "--iters", str(args.iters),
                            "--one", config, run], check=True)
    summary(args.out_dir, args.iters)


if __name__ == "__main__":
    main()
