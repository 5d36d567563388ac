"""The SVT baselines' final RRE at the full taxi shape on the CPU, in a
chosen dtype: the reference values `chip_smoke.py`'s phase 9 holds the card
to (`BASELINE_RRE`, from a float64 run).

The same call as the smoke's (`cli.run_completion.run_method`, the taxi
stand-in with 10% missing, seed 0, 100 iterations, the given SVT route) on
the CPU host loop; one JSON line a method. About 1-3 minutes a method in
float64 on 4 threads.

    python -m tritd_tpu_torch.tools.baseline_reference [--dtype float64] [--methods ttnn ring fctn] [--svt-method gram]
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    parser.add_argument("--methods", nargs="+", default=["ttnn", "ring", "fctn"])
    parser.add_argument("--svt-method", default="gram")
    parser.add_argument("--max-iter", type=int, default=100)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..cli.run_completion import run_method
    from ..data import load_dataset, uniform_missing_mask
    from ..metrics.recon import rre
    from ..utils.config import README_MISSING_RATIO

    x_np, spec, prov = load_dataset("taxi")
    mask = torch.as_tensor(uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO))
    x = torch.as_tensor(x_np, dtype=getattr(torch, args.dtype))
    y = torch.where(mask, x, torch.zeros_like(x))
    for method in args.methods:
        t0 = time.perf_counter()
        x_hat, _o, hist = run_method(method, y, x, mask, spec, torch.Generator().manual_seed(0), args.max_iter,
                                     svt_method=args.svt_method)
        print(json.dumps({"method": method, "dataset": f"taxi ({prov})", "dtype": args.dtype,
                          "svt_method": args.svt_method, "iters": len(hist), "rre": float(rre(x_hat, x)),
                          "err_last": float(hist[-1]), "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
