"""The SVT baselines' final RRE at the full taxi shape from the JAX package
in float64 on the CPU: the value, independent of the port's code, that
`chip_smoke.py` phase 9 holds the port's float32 run on the card to
(`BASELINE_RRE_JAX`), beside the port's own float64 CPU run
(`python -m tritd_tpu_torch.tools.baseline_reference`, `BASELINE_RRE`).

The smoke's inputs: the port's taxi stand-in (`tritd_tpu_torch.data.
load_dataset("taxi")`, drawn with numpy; the JAX package's own stand-in is
drawn with JAX's generator and differs), 10% of its entries missing by the
port's `uniform_missing_mask(np.random.default_rng(0), ...)` and
zero-filled, 100 iterations of the gram SVT route through the JAX
package's `cli.run_completion.run_method` with its taxi spec. One JSON line
a method; 35-85 s a method on 8 cores. Run from the repository root:

    JAX_PLATFORMS=cpu python docs/baseline_rre_reference.py [--methods ttnn ring fctn]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--methods", nargs="+", default=["ttnn", "ring", "fctn"])
    parser.add_argument("--svt-method", default="gram")
    parser.add_argument("--max-iter", type=int, default=100)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tritd_tpu.cli.run_completion import run_method
    from tritd_tpu.data.loaders import DATASETS
    from tritd_tpu.metrics.recon import rre
    from tritd_tpu.utils.config import README_MISSING_RATIO
    from tritd_tpu_torch.data import load_dataset, uniform_missing_mask

    x_np, _port_spec, prov = load_dataset("taxi")
    spec = DATASETS["taxi"]
    mask = uniform_missing_mask(np.random.default_rng(0), x_np.shape, README_MISSING_RATIO)
    x = jnp.asarray(x_np, jnp.float64)
    y = jnp.where(mask, x, 0.0)
    for method in args.methods:
        t0 = time.perf_counter()
        x_hat, _o, hist = run_method(method, y, x, jnp.asarray(mask), spec, jax.random.PRNGKey(0), args.max_iter,
                                     svt_method=args.svt_method)
        print(json.dumps({"method": method, "package": "tritd_tpu (JAX)", "dataset": f"taxi ({prov})",
                          "dtype": "float64", "svt_method": args.svt_method, "iters": len(hist),
                          "rre": float(rre(x_hat, x)), "err_last": float(hist[-1]),
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
