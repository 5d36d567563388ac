"""Validation of the randomized top-k SVT inside RC-FCTN's video protocol.

Counterpart of the JAX package's `tools/validate_lowrank_svt.py`. Runs the
highway-shape video solve twice, with the exact Gram-eigh SVT and with the
production route (randomized top-k on the square-ish bipartitions), and
reports the err_hist agreement and the final-X distance.

Usage:
  python -m tritd_tpu_torch.tools.validate_lowrank_svt [--iters 50]
      [--method auto:512] [--device cuda] [--out result.json]
      one run on the seeded highway stand-in (--method lowrank:256 to
      validate another budget);
  python -m tritd_tpu_torch.tools.validate_lowrank_svt --seeds 0,1,2 ...
      seed sweep: per seed a FRESH highway-shaped synthetic video (other
      data, hence other iterate spectra near the discontinuous `>1`
      truncation gate), with per-seed deltas in the result.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..baselines.rc_fctn import _split_mode3, rc_fctn
from ..cli.run_completion import resolve_device, timed
from ..data import load_dataset
from ..data.synthetic import synthetic_video


def compare_routes(y4, ind, n_iters: int, method: str) -> dict:
    """Solve with `method` and with exact gram; return agreement stats."""
    if method == "gram":
        # gram against gram would report a fake perfect validation
        raise ValueError("method='gram' IS the reference route; pick the candidate route"
                         " to validate (e.g. 'auto:512')")
    res = {}
    for meth in (method, "gram"):
        (xh, _s, hist), dt = timed(y4.device, lambda: rc_fctn(
            y4, 1.8, ind, origin=y4, f=0.7, max_iter=n_iters, svt_method=meth, chunk=25))
        res[meth] = (hist.cpu().numpy(), xh, dt)
        print(f"  {meth}: {dt:.2f}s err[first,last]={res[meth][0][0]:.4g},{res[meth][0][-1]:.4g}",
              flush=True)
    (hl, xl, tl), (hg, xg, tg) = res[method], res["gram"]
    return {
        "max_abs_hist_diff": float(np.max(np.abs(hl - hg))),
        "rel_final_x_diff": float(torch.linalg.vector_norm(xl - xg) / torch.linalg.vector_norm(xg)),
        "err_last_gram": float(hg[-1]),
        "seconds": {method: round(tl, 2), "gram": round(tg, 2)},
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", default=None)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--method", default="auto:512")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    x_np, spec, _prov = load_dataset("highway")
    sub = spec.fctn_subdim

    def problem(x_np):
        x = torch.as_tensor(x_np, dtype=torch.float32, device=device)
        n4 = x.shape[2] // sub
        return _split_mode3(x, sub, n4), _split_mode3(torch.ones_like(x), sub, n4)

    protocol = {"shape": list(x_np.shape), "subdim": sub, "n_iters": a.iters, "method": a.method,
                "device": str(device)}
    if a.seeds is None:
        result = {"protocol": protocol, **compare_routes(*problem(x_np), a.iters, a.method)}
    else:
        rows = []
        for seed in (int(s) for s in a.seeds.split(",")):
            print(f"seed {seed}:", flush=True)
            observed, _bg, _fg = synthetic_video(np.random.default_rng(seed), x_np.shape)
            rows.append({"seed": seed, **compare_routes(*problem(observed), a.iters, a.method)})
        result = {
            "protocol": protocol,
            "seeds": rows,
            "worst_max_abs_hist_diff": max(r["max_abs_hist_diff"] for r in rows),
            "worst_rel_final_x_diff": max(r["rel_final_x_diff"] for r in rows),
        }
    print(json.dumps(result, indent=1))
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"wrote {a.out}")
    return result


if __name__ == "__main__":
    main()
